"""pps_diff — PPS-latched time comparison CLI (apps/pps_diff.py
equivalent).

Compares the seconds-at-last-PPS of a device against a reference (a
second device or the host clock), after waiting for reference lock,
and reports per-second diffs, mean/std, and drift — the reference app's
procedure (the reference's apps/pps_diff.py: lock wait on a named
sensor, epsilon tolerance check, tick-diff accumulation).

Without hardware, ``--args sim`` compares a simulated disciplined clock
(host + bounded jitter) against the host clock.

The port's copy of ``grbaz_tpu/apps/pps_diff.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="PPS time difference monitor")
    ap.add_argument("-a", "--args", default="sim",
                    help="device args ('sim' = simulated PPS source)")
    ap.add_argument("-n", "--count", type=int, default=10)
    ap.add_argument("-i", "--interval", type=float, default=1.0)
    ap.add_argument("-e", "--epsilon", type=float, default=0.001,
                    help="diff tolerance before flagging")
    ap.add_argument("-s", "--sensor", default="ref_locked",
                    help="reference lock sensor name")
    ap.add_argument("-L", "--lock-timeout", type=float, default=5.0)
    args = ap.parse_args(argv)

    from grbaz_tpu_torch.net.hw_control import pps_diff

    if args.args == "sim":
        import random
        t0 = time.time()

        def time_a():
            # disciplined clock: host + 1 us jitter + tiny drift
            dt = time.time() - t0
            return time.time() + 1e-6 * random.uniform(-1, 1) + 1e-7 * dt

        lock = lambda: True
    else:
        from grbaz_tpu_torch.net.devices import create_device
        dev = create_device(args.args)
        time_a = dev.get_time_last_pps if hasattr(dev, "get_time_last_pps") \
            else getattr(dev, "time", time.time)
        sensors = getattr(dev, "sensors", lambda: {})
        lock = lambda: bool(sensors().get(args.sensor, True))

    deadline = time.time() + args.lock_timeout
    while not lock():
        if time.time() > deadline:
            print(f"reference never locked ({args.sensor})", file=sys.stderr)
            return 1
        time.sleep(0.1)

    res = pps_diff(time_a, n=args.count,
                   interval=args.interval if args.args != "sim" else 0.01)
    for i, d in enumerate(res["diffs"]):
        flag = "  <-- exceeds epsilon" if abs(d - res["mean"]) > args.epsilon \
            else ""
        print(f"[{i}] diff {d:+.9f} s{flag}")
    print(f"mean {res['mean']:+.9f} s, std {res['std']:.3e}, "
          f"drift {res['drift_per_interval']:+.3e} s/interval")
    return 0


if __name__ == "__main__":
    sys.exit(main())
