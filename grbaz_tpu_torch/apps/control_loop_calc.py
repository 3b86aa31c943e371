"""control_loop_calc — 2nd-order control loop coefficient calculator.

Equivalent of the reference's apps/control_loop_calc.py: converts
between the (alpha, beta) proportional+integrator gains of the standard
digital control loop and its (loop bandwidth, damping) description.
The conversions are the textbook critically-sampled loop relations

    denom = 1 + 2*d*bw + bw^2
    alpha = 4*d*bw / denom        beta = 4*bw^2 / denom

and their inversions. Pass any two and get the others.

The port's copy of ``grbaz_tpu/apps/control_loop_calc.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import argparse
import math
import sys


def bw_damping_to_alpha_beta(bw: float, damping: float):
    denom = 1.0 + 2.0 * damping * bw + bw * bw
    return 4.0 * damping * bw / denom, 4.0 * bw * bw / denom


def alpha_beta_to_bw_damping(alpha: float, beta: float):
    bw = math.sqrt(beta / (4.0 - 2.0 * alpha - beta))
    damping = (alpha * (-1.0 - bw * bw)) / (2.0 * bw * (alpha - 2.0))
    return bw, damping


def alpha_damping_to_bw(alpha: float, damping: float):
    """Both bandwidth roots for a given alpha and damping."""
    b = 2.0 * alpha * damping - 4.0 * damping
    disc = math.sqrt(b * b - 4.0 * alpha * alpha)
    return ((-b + disc) / (2.0 * alpha), (-b - disc) / (2.0 * alpha))


def beta_damping_to_bw(beta: float, damping: float):
    """Both bandwidth roots for a given beta and damping."""
    b = -2.0 * beta * damping
    disc = math.sqrt(b * b + 4.0 * (4.0 - beta) * beta)
    return ((-b + disc) / (2.0 * (4.0 - beta)),
            (-b - disc) / (2.0 * (4.0 - beta)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-a", "--alpha", type=float)
    ap.add_argument("-b", "--beta", type=float)
    ap.add_argument("-l", "--loop-bandwidth", type=float)
    ap.add_argument("-d", "--damping", type=float)
    args = ap.parse_args(argv)
    did = False
    if args.alpha is not None and args.beta is not None:
        bw, d = alpha_beta_to_bw_damping(args.alpha, args.beta)
        print("Bandwidth:\t%f\nDamping:\t%f" % (bw, d))
        did = True
    if args.loop_bandwidth is not None and args.damping is not None:
        a, b = bw_damping_to_alpha_beta(args.loop_bandwidth, args.damping)
        print("Alpha:\t%f\nBeta:\t%f" % (a, b))
        did = True
    if args.alpha is not None and args.damping is not None:
        x1, x2 = alpha_damping_to_bw(args.alpha, args.damping)
        print("Bandwidth 1:\t%f\nBandwidth 2:\t%f" % (x1, x2))
        did = True
    if args.beta is not None and args.damping is not None:
        x1, x2 = beta_damping_to_bw(args.beta, args.damping)
        print("Bandwidth 1:\t%f\nBandwidth 2:\t%f" % (x1, x2))
        did = True
    if not did:
        print("need two of: --alpha --beta --loop-bandwidth --damping",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
