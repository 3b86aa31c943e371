"""Faults planted underneath the timed path (the executor's graph step),
for the tests that must see ``correct`` come out false."""

import dataclasses


def _wrap(ex, around):
    step = ex._step_fn
    ex._step_fn = lambda states, params, ins: around(step, states, params,
                                                     ins)


def state_unchanged(ex):
    """Every step returns the states it was given."""
    _wrap(ex, lambda step, st, pr, ins: (st, step(st, pr, ins)[1]))


def half_block(ex):
    """The step sees the first half of each block and zeros after it."""
    def around(step, st, pr, ins):
        s = ins["iq"]
        d = s.data.clone()
        d[d.shape[0] // 2:] = 0
        return step(st, pr, {"iq": dataclasses.replace(s, data=d)})
    _wrap(ex, around)


def answer_altered(ex):
    """One output sample a block moved by 1e-3 where it is produced."""
    def around(step, st, pr, ins):
        st, outs = step(st, pr, ins)
        port = next(iter(outs))
        d = outs[port].data.clone()
        d.view(-1)[11] += 1e-3
        return st, dict(outs, **{port: dataclasses.replace(outs[port],
                                                           data=d)})
    _wrap(ex, around)


FAULTS = dict(state_unchanged=state_unchanged, half_block=half_block,
              answer_altered=answer_altered)
