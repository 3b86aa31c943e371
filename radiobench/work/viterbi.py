"""K3, the Viterbi decoder (``csrc/viterbi.cu``) over T soft pairs at
constraint length K: the forward pass (``viterbi_warp``, one warp, up to
K = 9; ``viterbi_block`` beyond), then the traceback cut into chunks
(``trace_map``: each chunk's map from end state to start state;
``trace_bits``: each chunk's bits)."""

from radiobench.work import bound_s

# the launches of one decode, each a pattern of the kernel's name
KERNELS = (r"viterbi_(warp|block)", r"trace_map", r"trace_bits")
TRACE_CHUNK = 512   # steps a traceback chunk (ops/cuda/viterbi.py)


def work(t_len: int, k: int, chunk: int = TRACE_CHUNK):
    """(bytes, FLOP): the pairs read (8 bytes a step); the decisions
    written and read back (a bit a state a step, each way); the chunks'
    maps written and read (4 bytes a state a chunk, each way); the bits
    written (a byte a step) and the final metrics (4 bytes a state). The
    operations are the function's least: a rate-1/2 step has four
    distinct branch metrics (+-r0 +-r1), 4 FLOP a step shared by every
    state, then 5 FLOP a state a step: two candidate sums, the
    compare-select, the max and the normalising subtraction."""
    ns = 1 << (k - 1)
    chunks = -(-t_len // chunk)
    return (8 * t_len + 2 * (t_len * ns // 8) + 2 * 4 * ns * chunks
            + t_len + 4 * ns, 4 * t_len + 5 * ns * t_len)


def bound(cfg: dict, block: int) -> float:
    """Seconds one decode needs at least, at a cell's shape: the block's
    pairs and the warm-up's."""
    return bound_s(*work(block + cfg["overlap"], cfg["k"]))
