"""Host reads of the subspace iteration a block: the program's
``music.sync`` spans over the blocks that have a ``block.music`` span
(profiled part of the window); None without them."""

from radiobench import program


def read(ctx):
    got = program.spans(ctx)
    if not got:
        return None
    blocks = {(s.stream, s.seq) for s in got
              if s.name == "block.music" and s.seq >= 0}
    if not blocks:
        return None
    return sum(1 for s in got if s.name == "music.sync"
               and (s.stream, s.seq) in blocks) / len(blocks)
