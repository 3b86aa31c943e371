"""gpsdo — GPSDO sensor monitor CLI (apps/gpsdo.py equivalent).

Polls a device's sensors (gps_locked / ref_locked / gps_time / NMEA /
gps_servo) on an interval, decodes the Jackson-Labs-style ``gps_servo``
telemetry line (1PPS count, fine DAC, UTC offset, frequency-error
estimate, satellite counts, lock state, health status — field layout
and status bit meanings documented in the reference's apps/gpsdo.py:93-117),
reports lock-state transitions and health-flag changes, and measures
gps-vs-host time drift. ``--fifo`` tees sensor lines to a pipe like the
reference; a time-series DB is out of scope (stub the callback).

Without hardware (the default), a simulated GPSDO exercises the whole
path: warmup -> locking -> locked, servo line included.

The port's copy of ``grbaz_tpu/apps/gpsdo.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time

LOCK_STATE = {
    0: "OCXO warmup",
    1: "Holdover",
    2: "Locking (OCXO training)",
    4: "[Value not defined]",
    5: "Holdover, but still phase locked",
    6: "Locked, and GPS active",
}

HEALTH_STATUS = {
    0x1: "OCXO coarse-DAC maxed-out at 255",
    0x2: "OCXO coarse-DAC mined-out at 0",
    0x4: "phase offset to UTC > 250 ns",
    0x8: "run-time < 300 s",
    0x10: "GPS in holdover > 60 s",
    0x20: "frequency estimate out of bounds",
    0x100: "short-term drift (ADEV @ 100 s) > 100 ns",
    0x200: "first 3 min after phase-reset / coarse-DAC change",
}


def parse_gps_servo(line: str) -> dict:
    """Parse a gps_servo sensor line:
    ``[date] [1PPS count] [fine DAC] [UTC offset ns] [freq error est]
    [sats visible] [sats tracked] [lock state] [health status]``."""
    parts = str(line).split()
    if len(parts) < 8:
        raise ValueError(f"short gps_servo line: {line!r}")
    # a leading date/time field is anything that isn't a plain number
    # (negative numeric fields like a -4.5 ns UTC offset must survive)
    try:
        float(parts[0])
    except ValueError:
        parts = parts[1:]
    if len(parts) < 8:
        raise ValueError(f"short gps_servo line: {line!r}")

    def _int_any_base(v: str) -> int:
        try:
            return int(v, 0)     # 0x.. hex, 0o.., plain decimal
        except ValueError:
            return int(v, 10)    # zero-padded decimal ('014')

    vals = dict(
        pps_count=int(float(parts[0])),
        fine_dac=float(parts[1]),
        utc_offset_ns=float(parts[2]),
        freq_error_estimate=float(parts[3]),
        sats_visible=int(float(parts[4])),
        sats_tracked=int(float(parts[5])),
        lock_state=int(float(parts[6])),
        health_status=_int_any_base(parts[7]),
    )
    vals["lock_state_str"] = LOCK_STATE.get(vals["lock_state"], "?")
    vals["health_flags"] = [desc for bit, desc in HEALTH_STATUS.items()
                            if vals["health_status"] & bit]
    return vals


class SimGPSDO:
    """Synthetic GPSDO: warmup -> locking -> locked over ~6 samples."""

    def __init__(self):
        self._n = itertools.count()

    def sensors(self) -> dict:
        n = next(self._n)
        lock = 0 if n < 2 else (2 if n < 4 else 6)
        health = 0x8 if n < 5 else 0
        return dict(
            gps_locked=lock == 6,
            ref_locked=n >= 3,
            gps_time=time.time() + 0.5e-6 * n,
            gps_servo=f"{n} 32000.5 {12 - n} 1.2e-12 9 7 {lock} {health:#x}",
        )


def main(argv=None):
    ap = argparse.ArgumentParser(description="GPSDO sensor monitor")
    ap.add_argument("-a", "--args", default="sim",
                    help="device args ('sim' = simulated GPSDO)")
    ap.add_argument("-i", "--interval", type=float, default=1.0)
    ap.add_argument("-n", "--count", type=int, default=6,
                    help="samples to take (0 = forever)")
    ap.add_argument("-f", "--fifo", default="",
                    help="tee sensor lines to this pipe/file")
    ap.add_argument("-s", "--silent", action="store_true")
    args = ap.parse_args(argv)

    from grbaz_tpu_torch.net.hw_control import GPSDOMonitor

    if args.args == "sim":
        source = SimGPSDO()
    else:
        from grbaz_tpu_torch.net.devices import create_device
        dev = create_device(args.args)
        if not hasattr(dev, "sensors"):
            print(f"device {args.args!r} exposes no sensors", file=sys.stderr)
            return 1
        source = dev

    fifo = open(args.fifo, "w") if args.fifo else None
    prev = {}

    def on_sample(vals):
        line_items = []
        if "gps_servo" in vals:
            try:
                servo = parse_gps_servo(vals["gps_servo"])
            except ValueError:
                servo = {}
            if servo:
                if servo["lock_state"] != prev.get("lock_state"):
                    print(f"lock state -> {servo['lock_state_str']}")
                    prev["lock_state"] = servo["lock_state"]
                if servo["health_status"] != prev.get("health"):
                    flags = "; ".join(servo["health_flags"]) or "healthy"
                    print(f"health -> {flags}")
                    prev["health"] = servo["health_status"]
                line_items.append(f"dac={servo['fine_dac']} "
                                  f"utc_ofs={servo['utc_offset_ns']}ns "
                                  f"sats={servo['sats_tracked']}/"
                                  f"{servo['sats_visible']}")
        for k in ("gps_locked", "ref_locked", "_gps_host_diff"):
            if k in vals:
                line_items.append(f"{k.lstrip('_')}={vals[k]}")
        line = " ".join(str(i) for i in line_items)
        if not args.silent:
            print(line)
        if fifo:
            fifo.write(line + "\n")
            fifo.flush()

    mon = GPSDOMonitor(source, interval=args.interval, on_sample=on_sample)
    try:
        if args.count:
            for _ in range(args.count):
                mon.sample()
                if _ + 1 < args.count:
                    time.sleep(args.interval)
        else:
            mon.start()
            while True:
                time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        mon.stop()
        if fifo:
            fifo.close()
    print(f"drift: {mon.drift():+.3e} s/sample over {len(mon.history)} "
          f"samples; {len(mon.lock_transitions)} lock transitions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
