// boripnet — native BorIP/raw UDP sample-plane engine.
//
// The hot path of the reference's network plane is C++
// (the reference's lib/baz_udp_source.cc, baz_udp_sink.cc): a UDP
// receiver with a 4-byte BorIP header {u8 flags, u8 notification,
// u16 seq}, sequence-gap detection, and fault flags
// (BF_HARDWARE/NETWORK/BUFFER_OVERRUN, BF_EMPTY_PAYLOAD,
// BF_STREAM_START/END — baz_udp_source.cc:74-127), and a sender that
// stamps the same header (baz_udp_sink.cc:69-78).
//
// The port's copy of the JAX package's engine (grbaz_tpu/native/
// boripnet.cc), unchanged in function: a dedicated receive thread fills
// a lock-light ring buffer sized in packets; the Python side drains
// contiguous payload bytes in bulk (feeding the card's ingest pipeline).
// Exposed as a C ABI for ctypes — no pybind11 dependency.
//
// Built by grbaz_tpu_torch/native/__init__.py into grbaz_tpu_torch/_build/:
// g++ -O2 -shared -fPIC -pthread -std=c++17 -o libboripnet-<hash>.so

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

#pragma pack(push, 1)
struct BorHeader {
  uint8_t flags;
  uint8_t notification;
  uint16_t idx;  // little-endian sequence index
};

// ATA (Allen Telescope Array) sample-packet header — the third wire
// dialect of the reference UDP source (baz_udp_source.cc:85-100):
// 64 packed bytes carrying stream metadata and a 32-bit sequence id.
struct AtaHeader {
  uint8_t group, version, bits_per_sample, binary_point;
  uint32_t order;
  uint8_t type, streams, pol_code, hdr_len;
  uint32_t src;
  uint32_t chan;
  uint32_t seq;
  double freq;
  double sample_rate;
  float usable_fraction;
  float reserved;
  uint64_t abs_time;
  uint32_t flags;
  uint32_t len;
};
#pragma pack(pop)

static_assert(sizeof(AtaHeader) == 64, "ATA header must be 64 bytes");

enum BorFlags {
  BF_NONE = 0x00,
  BF_HARDWARE_OVERRUN = 0x01,
  BF_NETWORK_OVERRUN = 0x02,
  BF_BUFFER_OVERRUN = 0x04,
  BF_EMPTY_PAYLOAD = 0x08,
  BF_STREAM_START = 0x10,
  BF_STREAM_END = 0x20,
};

enum Mode { MODE_RAW = 0, MODE_BOR = 1, MODE_ATA = 2 };

struct RxEngine {
  int fd = -1;
  int mode = MODE_RAW;
  size_t payload = 1472;
  size_t slot_size = 0;        // payload bytes per ring slot
  size_t n_slots = 0;
  std::vector<uint8_t> ring;   // n_slots * slot_size payload bytes
  std::vector<uint32_t> lens;  // payload bytes per slot
  std::vector<uint8_t> flagv;  // header flags per slot
  std::atomic<uint64_t> head{0};  // next slot to write (producer)
  std::atomic<uint64_t> tail{0};  // next slot to read (consumer)
  std::atomic<uint64_t> packets{0};
  std::atomic<uint64_t> dropped_seq{0};   // holes detected via idx
  std::atomic<uint64_t> ring_overruns{0};  // consumer too slow
  std::atomic<uint8_t> sticky_flags{0};
  std::atomic<bool> running{false};
  bool seq_valid = false;
  uint16_t next_seq = 0;
  uint32_t next_seq32 = 0;  // ATA mode uses a 32-bit sequence counter
  // last-seen ATA stream metadata (written by rx thread, read via
  // borip_rx_ata_info; doubles are stored as bit patterns for atomicity)
  std::atomic<uint64_t> ata_freq_bits{0};
  std::atomic<uint64_t> ata_rate_bits{0};
  std::atomic<uint64_t> ata_abs_time{0};
  std::atomic<uint32_t> ata_bits_per_sample{0};
  std::thread thr;
};

struct TxEngine {
  int fd = -1;
  sockaddr_in dest{};
  bool have_dest = false;
  int mode = MODE_RAW;
  size_t payload = 1472;
  uint16_t seq = 0;
  uint32_t seq32 = 0;
  bool started = false;
  // ATA-mode stream metadata (stamped into every header)
  double ata_freq = 0.0;
  double ata_rate = 0.0;
  uint32_t ata_chan = 0;
  uint32_t ata_src = 0;
  uint8_t ata_bits_per_sample = 16;
  uint32_t ata_item_bytes = 4;  // bytes per sample item (abs_time step)
  uint64_t ata_abs_time = 0;
  std::vector<uint8_t> buf;
};

void rx_loop(RxEngine* e) {
  std::vector<uint8_t> pkt(e->payload + sizeof(AtaHeader));
  while (e->running.load(std::memory_order_relaxed)) {
    pollfd pfd{e->fd, POLLIN, 0};
    int pr = poll(&pfd, 1, 100);
    if (pr <= 0) continue;
    ssize_t r = recv(e->fd, pkt.data(), pkt.size(), 0);
    if (r <= 0) continue;
    const uint8_t* payload = pkt.data();
    size_t plen = (size_t)r;
    uint8_t flags = 0;
    if (e->mode == MODE_BOR) {
      if (plen < sizeof(BorHeader)) continue;
      BorHeader h;
      memcpy(&h, pkt.data(), sizeof(h));
      payload += sizeof(BorHeader);
      plen -= sizeof(BorHeader);
      flags = h.flags;
      if (h.flags & BF_STREAM_START) {
        e->seq_valid = true;
        e->next_seq = (uint16_t)(h.idx + 1);
      } else if (e->seq_valid) {
        if (h.idx != e->next_seq) {
          uint16_t gap = (uint16_t)(h.idx - e->next_seq);
          e->dropped_seq.fetch_add(gap, std::memory_order_relaxed);
          flags |= BF_NETWORK_OVERRUN;
        }
        e->next_seq = (uint16_t)(h.idx + 1);
      } else {
        e->seq_valid = true;
        e->next_seq = (uint16_t)(h.idx + 1);
      }
      if (h.flags & BF_EMPTY_PAYLOAD) plen = 0;
    } else if (e->mode == MODE_ATA) {
      if (plen < sizeof(AtaHeader)) continue;
      AtaHeader h;
      memcpy(&h, pkt.data(), sizeof(h));
      payload += sizeof(AtaHeader);
      plen -= sizeof(AtaHeader);
      if (e->seq_valid) {
        if (h.seq != e->next_seq32) {
          e->dropped_seq.fetch_add((uint32_t)(h.seq - e->next_seq32),
                                   std::memory_order_relaxed);
          flags |= BF_NETWORK_OVERRUN;
        }
      } else {
        e->seq_valid = true;
      }
      e->next_seq32 = h.seq + 1;
      uint64_t fb, rb;
      memcpy(&fb, &h.freq, sizeof(fb));
      memcpy(&rb, &h.sample_rate, sizeof(rb));
      e->ata_freq_bits.store(fb, std::memory_order_relaxed);
      e->ata_rate_bits.store(rb, std::memory_order_relaxed);
      e->ata_abs_time.store(h.abs_time, std::memory_order_relaxed);
      e->ata_bits_per_sample.store(h.bits_per_sample,
                                   std::memory_order_relaxed);
      if (h.len && h.len < plen) plen = h.len;  // trust declared length
    }
    uint64_t head = e->head.load(std::memory_order_relaxed);
    uint64_t tail = e->tail.load(std::memory_order_acquire);
    if (head - tail >= e->n_slots) {  // ring full: drop oldest
      e->ring_overruns.fetch_add(1, std::memory_order_relaxed);
      e->sticky_flags.fetch_or(BF_BUFFER_OVERRUN, std::memory_order_relaxed);
      e->tail.store(tail + 1, std::memory_order_release);
    }
    size_t slot = (size_t)(head % e->n_slots);
    if (plen > e->slot_size) plen = e->slot_size;
    memcpy(&e->ring[slot * e->slot_size], payload, plen);
    e->lens[slot] = (uint32_t)plen;
    e->flagv[slot] = flags;
    e->sticky_flags.fetch_or(flags, std::memory_order_relaxed);
    e->head.store(head + 1, std::memory_order_release);
    e->packets.fetch_add(1, std::memory_order_relaxed);
  }
}

}  // namespace

extern "C" {

void* borip_rx_create(uint16_t port, uint32_t payload_size,
                      uint32_t ring_packets, int mode,
                      uint32_t sock_buf_bytes) {
  RxEngine* e = new RxEngine();
  e->mode = mode;
  e->payload = payload_size;
  e->slot_size = payload_size;
  e->n_slots = ring_packets ? ring_packets : 4096;
  e->ring.resize(e->n_slots * e->slot_size);
  e->lens.resize(e->n_slots);
  e->flagv.resize(e->n_slots);
  e->fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (e->fd < 0) { delete e; return nullptr; }
  int one = 1;
  setsockopt(e->fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  if (sock_buf_bytes) {
    int sz = (int)sock_buf_bytes;
    setsockopt(e->fd, SOL_SOCKET, SO_RCVBUF, &sz, sizeof(sz));
  }
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (bind(e->fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
    close(e->fd);
    delete e;
    return nullptr;
  }
  e->running.store(true);
  e->thr = std::thread(rx_loop, e);
  return e;
}

uint16_t borip_rx_port(void* h) {
  RxEngine* e = (RxEngine*)h;
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  getsockname(e->fd, (sockaddr*)&addr, &len);
  return ntohs(addr.sin_port);
}

// Drain up to max_bytes of contiguous payload into out. Returns bytes
// copied; *flags_out accumulates header/ring fault flags seen.
int64_t borip_rx_read(void* h, uint8_t* out, int64_t max_bytes,
                      uint8_t* flags_out) {
  RxEngine* e = (RxEngine*)h;
  int64_t copied = 0;
  uint8_t flags = e->sticky_flags.exchange(0, std::memory_order_relaxed);
  uint64_t tail = e->tail.load(std::memory_order_relaxed);
  while (copied < max_bytes) {
    uint64_t head = e->head.load(std::memory_order_acquire);
    if (tail >= head) break;
    size_t slot = (size_t)(tail % e->n_slots);
    uint32_t len = e->lens[slot];
    if (copied + (int64_t)len > max_bytes) break;
    memcpy(out + copied, &e->ring[slot * e->slot_size], len);
    copied += len;
    flags |= e->flagv[slot];
    tail++;
  }
  e->tail.store(tail, std::memory_order_release);
  if (flags_out) *flags_out = flags;
  return copied;
}

void borip_rx_stats(void* h, uint64_t* packets, uint64_t* dropped,
                    uint64_t* overruns) {
  RxEngine* e = (RxEngine*)h;
  if (packets) *packets = e->packets.load();
  if (dropped) *dropped = e->dropped_seq.load();
  if (overruns) *overruns = e->ring_overruns.load();
}

void borip_rx_destroy(void* h) {
  RxEngine* e = (RxEngine*)h;
  e->running.store(false);
  if (e->thr.joinable()) e->thr.join();
  if (e->fd >= 0) close(e->fd);
  delete e;
}

void* borip_tx_create(const char* host, uint16_t port, uint32_t payload_size,
                      int mode) {
  TxEngine* e = new TxEngine();
  e->mode = mode;
  e->payload = payload_size;
  e->fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (e->fd < 0) { delete e; return nullptr; }
  e->buf.resize(payload_size + sizeof(AtaHeader));
  if (host && host[0]) {
    e->dest.sin_family = AF_INET;
    e->dest.sin_port = htons(port);
    if (inet_pton(AF_INET, host, &e->dest.sin_addr) != 1) {
      close(e->fd);
      delete e;
      return nullptr;
    }
    e->have_dest = true;
  }
  return e;
}

int borip_tx_connect(void* h, const char* host, uint16_t port) {
  TxEngine* e = (TxEngine*)h;
  e->dest.sin_family = AF_INET;
  e->dest.sin_port = htons(port);
  if (inet_pton(AF_INET, host, &e->dest.sin_addr) != 1) return -1;
  e->have_dest = true;
  return 0;
}

// Send data, chunked into payload-size packets (BorIP header + seq in
// BOR mode; BF_STREAM_START on the first packet after create/restart).
int64_t borip_tx_send(void* h, const uint8_t* data, int64_t len,
                      uint8_t extra_flags) {
  TxEngine* e = (TxEngine*)h;
  if (!e->have_dest) return -1;
  int64_t sent = 0;
  while (sent < len) {
    size_t chunk = (size_t)((len - sent) > (int64_t)e->payload
                                ? e->payload
                                : (len - sent));
    if (e->mode == MODE_BOR) {
      BorHeader hdr{};
      hdr.flags = extra_flags;
      if (!e->started) {
        hdr.flags |= BF_STREAM_START;
        e->started = true;
      }
      hdr.idx = e->seq++;
      memcpy(e->buf.data(), &hdr, sizeof(hdr));
      memcpy(e->buf.data() + sizeof(hdr), data + sent, chunk);
      ssize_t r = sendto(e->fd, e->buf.data(), chunk + sizeof(hdr), 0,
                         (sockaddr*)&e->dest, sizeof(e->dest));
      if (r < 0) return sent > 0 ? sent : -1;
    } else if (e->mode == MODE_ATA) {
      AtaHeader hdr{};
      hdr.version = 1;
      hdr.bits_per_sample = e->ata_bits_per_sample;
      hdr.hdr_len = sizeof(AtaHeader);
      hdr.streams = 1;
      hdr.src = e->ata_src;
      hdr.chan = e->ata_chan;
      hdr.seq = e->seq32++;
      hdr.freq = e->ata_freq;
      hdr.sample_rate = e->ata_rate;
      hdr.usable_fraction = 1.0f;
      hdr.abs_time = e->ata_abs_time;
      hdr.len = (uint32_t)chunk;
      e->ata_abs_time += chunk / (e->ata_item_bytes ? e->ata_item_bytes : 1);
      memcpy(e->buf.data(), &hdr, sizeof(hdr));
      memcpy(e->buf.data() + sizeof(hdr), data + sent, chunk);
      ssize_t r = sendto(e->fd, e->buf.data(), chunk + sizeof(hdr), 0,
                         (sockaddr*)&e->dest, sizeof(e->dest));
      if (r < 0) return sent > 0 ? sent : -1;
    } else {
      ssize_t r = sendto(e->fd, data + sent, chunk, 0, (sockaddr*)&e->dest,
                         sizeof(e->dest));
      if (r < 0) return sent > 0 ? sent : -1;
    }
    sent += chunk;
  }
  return sent;
}

// Send a zero-payload end-of-stream packet (BF_STREAM_END).
int borip_tx_end(void* h) {
  TxEngine* e = (TxEngine*)h;
  if (!e->have_dest || e->mode != MODE_BOR) return -1;
  BorHeader hdr{};
  hdr.flags = BF_STREAM_END | BF_EMPTY_PAYLOAD;
  hdr.idx = e->seq++;
  e->started = false;
  ssize_t r = sendto(e->fd, &hdr, sizeof(hdr), 0, (sockaddr*)&e->dest,
                     sizeof(e->dest));
  return r < 0 ? -1 : 0;
}

// ATA-mode stream metadata: read back what the RX thread last saw.
void borip_rx_ata_info(void* h, double* freq, double* rate,
                       uint64_t* abs_time, uint32_t* bits_per_sample) {
  RxEngine* e = (RxEngine*)h;
  uint64_t fb = e->ata_freq_bits.load(std::memory_order_relaxed);
  uint64_t rb = e->ata_rate_bits.load(std::memory_order_relaxed);
  if (freq) memcpy(freq, &fb, sizeof(fb));
  if (rate) memcpy(rate, &rb, sizeof(rb));
  if (abs_time) *abs_time = e->ata_abs_time.load(std::memory_order_relaxed);
  if (bits_per_sample)
    *bits_per_sample = e->ata_bits_per_sample.load(std::memory_order_relaxed);
}

// Configure the metadata stamped into outgoing ATA headers.
void borip_tx_ata_meta(void* h, double freq, double rate, uint32_t chan,
                       uint32_t src, uint32_t bits_per_sample,
                       uint32_t item_bytes) {
  TxEngine* e = (TxEngine*)h;
  e->ata_freq = freq;
  e->ata_rate = rate;
  e->ata_chan = chan;
  e->ata_src = src;
  e->ata_bits_per_sample = (uint8_t)bits_per_sample;
  e->ata_item_bytes = item_bytes;
}

void borip_tx_destroy(void* h) {
  TxEngine* e = (TxEngine*)h;
  if (e->fd >= 0) close(e->fd);
  delete e;
}

}  // extern "C"
