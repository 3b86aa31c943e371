// tcpframe — native TCP typed-frame sample-plane engine.
//
// The reference's TCP sample plane is C++
// (the reference's lib/baz_tcp_sink.cc:78-93,269-288 and
// baz_tcp_source.cc:374-400): frames are
//
//     header { u8 type, u8 flags, u32 length (LE) } + payload
//
// with BT_DATA carrying raw samples, BT_TAGS carrying a serialized tag
// dictionary that the receiver re-injects ahead of the next data frame,
// and an empty BF_STREAM_END frame at end-of-stream. The sink connects
// out (blocking or drop mode, auto-reconnect); the source listens and
// serves one client at a time.
//
// This engine is the bulk-data hot path for the port's
// net/tcp.py protocol layer: a dedicated receiver thread parses frames
// straight into a byte ring (data) and a small tag queue (tags are
// control-rate; Python decodes the JSON), and the sender side provides
// framed writes with reconnect handling. C ABI for ctypes.
//
// The port's copy of the JAX package's engine (grbaz_tpu/native/
// tcpframe.cc), unchanged in function. Built by
// grbaz_tpu_torch/native/__init__.py into grbaz_tpu_torch/_build/:
// g++ -O2 -shared -fPIC -pthread -std=c++17 -o libtcpframe-<hash>.so

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <netdb.h>
#include <poll.h>
#include <string>
#include <sys/socket.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

#pragma pack(push, 1)
struct FrameHeader {
  uint8_t type;
  uint8_t flags;
  uint32_t length;  // little-endian payload bytes
};
#pragma pack(pop)

static_assert(sizeof(FrameHeader) == 6, "frame header must be 6 bytes");

enum FrameType { BT_NONE = 0x00, BT_DATA = 0x01, BT_TAGS = 0x02 };
enum FrameFlags { BF_NONE = 0x00, BF_STREAM_END = 0x20 };

constexpr size_t kMaxTagBytes = 1 << 20;  // sanity cap on tag frames

// ---------------------------------------------------------------------------
// receiver: listen -> accept one client -> parse frames into ring
// ---------------------------------------------------------------------------

struct TagEntry {
  uint64_t data_offset;  // byte offset into the data stream it precedes
  std::vector<uint8_t> blob;
};

struct SrcEngine {
  int listen_fd = -1;
  uint16_t port = 0;
  // byte ring for BT_DATA payloads
  std::vector<uint8_t> ring;
  size_t cap = 0;
  std::atomic<uint64_t> head{0};  // producer byte position
  std::atomic<uint64_t> tail{0};  // consumer byte position
  // tag queue (rare); protected by mu
  std::mutex mu;
  std::deque<TagEntry> tags;
  std::atomic<uint64_t> frames{0};
  std::atomic<uint64_t> bytes{0};
  std::atomic<uint64_t> ring_overruns{0};
  std::atomic<bool> stream_end{false};
  std::atomic<bool> running{false};
  std::atomic<bool> connected{false};
  std::thread thr;
};

bool recv_exact(SrcEngine* e, int fd, uint8_t* dst, size_t n) {
  size_t got = 0;
  while (got < n && e->running.load(std::memory_order_relaxed)) {
    pollfd p{fd, POLLIN, 0};
    int pr = poll(&p, 1, 100);
    if (pr < 0) return false;
    if (pr == 0) continue;
    ssize_t r = recv(fd, dst + got, n - got, 0);
    if (r <= 0) return false;
    got += static_cast<size_t>(r);
  }
  return got == n;
}

void src_client_loop(SrcEngine* e, int fd) {
  std::vector<uint8_t> payload;
  while (e->running.load(std::memory_order_relaxed)) {
    FrameHeader h;
    if (!recv_exact(e, fd, reinterpret_cast<uint8_t*>(&h), sizeof(h))) return;
    size_t len = h.length;  // already LE on all supported targets
    if (h.flags & BF_STREAM_END) e->stream_end.store(true);
    if (len == 0) continue;
    if (h.type == BT_TAGS) {
      if (len > kMaxTagBytes) return;  // protocol error: drop client
      TagEntry t;
      t.blob.resize(len);
      if (!recv_exact(e, fd, t.blob.data(), len)) return;
      t.data_offset = e->head.load(std::memory_order_relaxed);
      std::lock_guard<std::mutex> g(e->mu);
      e->tags.push_back(std::move(t));
      continue;
    }
    if (h.type != BT_DATA) {  // unknown type: skip payload
      payload.resize(len);
      if (!recv_exact(e, fd, payload.data(), len)) return;
      continue;
    }
    // data: receive straight into the ring (wrap-aware)
    uint64_t head = e->head.load(std::memory_order_relaxed);
    uint64_t tail = e->tail.load(std::memory_order_acquire);
    if (head + len - tail > e->cap) {
      // consumer too slow: drop this frame (drop-newest keeps the
      // stream prefix intact, mirroring the UDP engine's accounting)
      e->ring_overruns.fetch_add(1);
      payload.resize(len);
      if (!recv_exact(e, fd, payload.data(), len)) return;
      continue;
    }
    size_t pos = static_cast<size_t>(head % e->cap);
    size_t first = std::min(len, e->cap - pos);
    if (!recv_exact(e, fd, e->ring.data() + pos, first)) return;
    if (first < len &&
        !recv_exact(e, fd, e->ring.data(), len - first)) return;
    e->head.store(head + len, std::memory_order_release);
    e->frames.fetch_add(1);
    e->bytes.fetch_add(len);
  }
}

void src_thread(SrcEngine* e) {
  while (e->running.load(std::memory_order_relaxed)) {
    pollfd p{e->listen_fd, POLLIN, 0};
    int pr = poll(&p, 1, 100);
    if (pr < 0) return;
    if (pr == 0) continue;
    int fd = accept(e->listen_fd, nullptr, nullptr);
    if (fd < 0) continue;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    e->connected.store(true);
    src_client_loop(e, fd);
    e->connected.store(false);
    close(fd);
  }
}

// ---------------------------------------------------------------------------
// sender: framed writes with optional auto-reconnect
// ---------------------------------------------------------------------------

struct SinkEngine {
  std::string host;
  uint16_t port = 0;
  int fd = -1;
  bool auto_reconnect = false;
  std::mutex mu;
  std::atomic<uint64_t> frames{0};
  std::atomic<uint64_t> bytes{0};
  std::atomic<uint64_t> send_failures{0};
};

bool sink_connect_locked(SinkEngine* e) {
  if (e->fd >= 0) return true;
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  char portstr[8];
  snprintf(portstr, sizeof(portstr), "%u", e->port);
  if (getaddrinfo(e->host.c_str(), portstr, &hints, &res) != 0 || !res)
    return false;
  int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  bool ok = fd >= 0 && connect(fd, res->ai_addr, res->ai_addrlen) == 0;
  freeaddrinfo(res);
  if (!ok) {
    if (fd >= 0) close(fd);
    return false;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  e->fd = fd;
  return true;
}

bool send_all(int fd, const uint8_t* src, size_t n) {
  size_t sent = 0;
  while (sent < n) {
    ssize_t r = send(fd, src + sent, n - sent, MSG_NOSIGNAL);
    if (r <= 0) return false;
    sent += static_cast<size_t>(r);
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* tcpf_src_create(uint16_t port, uint64_t ring_bytes) {
  auto* e = new SrcEngine();
  e->cap = ring_bytes ? ring_bytes : (1 << 24);
  e->ring.resize(e->cap);
  e->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (e->listen_fd < 0) { delete e; return nullptr; }
  int one = 1;
  setsockopt(e->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (bind(e->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0
      || listen(e->listen_fd, 1) < 0) {
    close(e->listen_fd);
    delete e;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(e->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  e->port = ntohs(addr.sin_port);
  e->running.store(true);
  e->thr = std::thread(src_thread, e);
  return e;
}

uint16_t tcpf_src_port(void* h) {
  return static_cast<SrcEngine*>(h)->port;
}

// Pop up to max_bytes of contiguous data-stream bytes. Returns bytes
// copied. *offset_out is the stream byte offset of the first copied byte.
int64_t tcpf_src_read(void* h, uint8_t* dst, int64_t max_bytes,
                      uint64_t* offset_out) {
  auto* e = static_cast<SrcEngine*>(h);
  uint64_t tail = e->tail.load(std::memory_order_relaxed);
  uint64_t head = e->head.load(std::memory_order_acquire);
  uint64_t avail = head - tail;
  uint64_t n = avail < static_cast<uint64_t>(max_bytes)
                   ? avail
                   : static_cast<uint64_t>(max_bytes);
  if (offset_out) *offset_out = tail;
  if (n == 0) return 0;
  size_t pos = static_cast<size_t>(tail % e->cap);
  size_t first = std::min(static_cast<size_t>(n), e->cap - pos);
  memcpy(dst, e->ring.data() + pos, first);
  if (first < n) memcpy(dst + first, e->ring.data(), n - first);
  e->tail.store(tail + n, std::memory_order_release);
  return static_cast<int64_t>(n);
}

// Pop the next tag blob if its data offset is < up_to_offset, i.e. the
// sample the tag is pinned to has already been drained (a tag stamped
// at the boundary belongs to the NEXT read's data). After STREAM_END
// any remaining tags flush unconditionally. Returns blob bytes (0 =
// none, -1 = caller buffer too small; call again with a bigger buffer).
int64_t tcpf_src_next_tag(void* h, uint8_t* dst, int64_t cap,
                          uint64_t up_to_offset, uint64_t* tag_offset_out) {
  auto* e = static_cast<SrcEngine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->tags.empty()) return 0;
  TagEntry& t = e->tags.front();
  if (t.data_offset >= up_to_offset && !e->stream_end.load()) return 0;
  if (static_cast<int64_t>(t.blob.size()) > cap) return -1;
  if (tag_offset_out) *tag_offset_out = t.data_offset;
  int64_t n = static_cast<int64_t>(t.blob.size());
  memcpy(dst, t.blob.data(), t.blob.size());
  e->tags.pop_front();
  return n;
}

void tcpf_src_stats(void* h, uint64_t* frames, uint64_t* bytes,
                    uint64_t* overruns, int* stream_end, int* connected) {
  auto* e = static_cast<SrcEngine*>(h);
  if (frames) *frames = e->frames.load();
  if (bytes) *bytes = e->bytes.load();
  if (overruns) *overruns = e->ring_overruns.load();
  if (stream_end) *stream_end = e->stream_end.load() ? 1 : 0;
  if (connected) *connected = e->connected.load() ? 1 : 0;
}

void tcpf_src_destroy(void* h) {
  auto* e = static_cast<SrcEngine*>(h);
  e->running.store(false);
  if (e->thr.joinable()) e->thr.join();
  if (e->listen_fd >= 0) close(e->listen_fd);
  delete e;
}

void* tcpf_sink_create(const char* host, uint16_t port, int auto_reconnect) {
  auto* e = new SinkEngine();
  e->host = host ? host : "127.0.0.1";
  e->port = port;
  e->auto_reconnect = auto_reconnect != 0;
  bool ok;
  {  // guard must release before a potential delete (unlocking a
     // destroyed mutex is UB)
    std::lock_guard<std::mutex> g(e->mu);
    ok = sink_connect_locked(e);
  }
  if (!ok && !e->auto_reconnect) {
    delete e;
    return nullptr;
  }
  return e;
}

// Send one framed payload. Returns 1 on success, 0 on failure (socket
// dropped; will reconnect next call when auto_reconnect).
int tcpf_sink_send(void* h, uint8_t type, uint8_t flags,
                   const uint8_t* payload, uint64_t len) {
  auto* e = static_cast<SinkEngine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  if (e->fd < 0) {
    if (!e->auto_reconnect || !sink_connect_locked(e)) {
      e->send_failures.fetch_add(1);
      return 0;
    }
  }
  FrameHeader hd{type, flags, static_cast<uint32_t>(len)};
  bool ok = send_all(e->fd, reinterpret_cast<uint8_t*>(&hd), sizeof(hd)) &&
            (len == 0 || send_all(e->fd, payload, len));
  if (!ok) {
    close(e->fd);
    e->fd = -1;
    e->send_failures.fetch_add(1);
    return 0;
  }
  e->frames.fetch_add(1);
  e->bytes.fetch_add(len);
  return 1;
}

int tcpf_sink_connected(void* h) {
  auto* e = static_cast<SinkEngine*>(h);
  std::lock_guard<std::mutex> g(e->mu);
  return e->fd >= 0 ? 1 : 0;
}

void tcpf_sink_stats(void* h, uint64_t* frames, uint64_t* bytes,
                     uint64_t* failures) {
  auto* e = static_cast<SinkEngine*>(h);
  if (frames) *frames = e->frames.load();
  if (bytes) *bytes = e->bytes.load();
  if (failures) *failures = e->send_failures.load();
}

void tcpf_sink_destroy(void* h) {
  auto* e = static_cast<SinkEngine*>(h);
  {
    std::lock_guard<std::mutex> g(e->mu);
    if (e->fd >= 0) close(e->fd);
  }
  delete e;
}

}  // extern "C"
