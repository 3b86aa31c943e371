"""Ranks of the port's multi-device tests: worlds of gloo processes on
the CPU, and the cases they run.

:func:`spawn` (called from a test) writes each case's numpy inputs under
a directory, starts ``world`` processes of this file, and waits for all
of them up to a deadline, killing the world if one hangs. Each rank
joins a gloo process group through a ``file://`` rendezvous in that
directory (so parallel tests never share a port), with a timeout, runs
the cases in order and writes its outputs as ``<case>_<rank>.npz``.
Ranks import torch, numpy and the port, never JAX.

    python tests/torch_dist_worker.py <rank> <world> <dir> <case> ...
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 90         # the process group's, per collective


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def spawn(world: int, cases, tmp_dir, deadline_s: float = 240.0):
    """Run ``cases`` (name -> dict of numpy inputs, each with a ``case``
    key naming its function in :data:`CASES`) in a world of ``world``
    gloo ranks. Returns ``{name: [outputs of rank 0, 1, ...]}``."""
    os.makedirs(tmp_dir, exist_ok=True)
    for name, inputs in cases.items():
        np.savez(os.path.join(tmp_dir, f"{name}.npz"), **inputs)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    logs = [open(os.path.join(tmp_dir, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), str(r), str(world),
         str(tmp_dir), *cases], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f.read())
        f.close()
    if hung:
        raise AssertionError(
            f"world of {world} passed its {deadline_s} s deadline (ranks "
            f"{hung} still running):\n" + "\n".join(t[-2000:] for t in text))
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {world} failed:\n"
                                 f"{text[r][-4000:]}")
    return {name: [dict(np.load(os.path.join(tmp_dir, f"{name}_{r}.npz")))
                   for r in range(world)] for name in cases}


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------

def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def case_collectives(inp):
    """psum, replicate, ppermute (cyclic, linear, reversed) and
    all_gather over the world, over one dim of a (2, 2) mesh, and over
    groups of one rank."""
    import torch
    import torch.distributed as dist

    from grbaz_tpu_torch.parallel import _collectives as col

    rank, world = dist.get_rank(), dist.get_world_size()
    g = dist.group.WORLD
    f = torch.arange(6, dtype=torch.float32) + 10.0 * rank
    c = torch.complex(f, -f)
    i = torch.arange(3, dtype=torch.int64) * (2 ** 33) + rank
    b = torch.tensor([rank % 2 == 0, rank == 1])
    out = dict(
        psum_f=col.psum(f, g), psum_c=col.psum(c, g), psum_i=col.psum(i, g),
        rep_f=col.replicate(f, world - 1, g),
        rep_c=col.replicate(c, world - 1, g),
        rep_b=col.replicate(b, 1 % world, g),
        cyc=col.ppermute(c, [(s, (s + 1) % world) for s in range(world)], g),
        lin=col.ppermute(f, [(s, s + 1) for s in range(world - 1)], g),
        rev=col.ppermute(i, [(s, s - 1) for s in range(1, world)], g),
        gather=col.all_gather(c, g))
    if world == 4:
        mesh = _mesh((2, 2), ("chan", "time"))
        tg, t_idx, _ = col.dim(mesh, "time")
        out["time_psum"] = col.psum(f, tg)
        out["time_cyc"] = col.ppermute(f, [(0, 1), (1, 0)], tg)
        out["shard"] = col.shard(torch.arange(8.0), mesh, "time")
        out["coord"] = torch.tensor([col.dim(mesh, "chan")[1], t_idx])
    # one group per rank (every rank creates every group)
    ones = [dist.new_group([r], backend="gloo") for r in range(world)]
    one = ones[rank]
    out.update(one_psum=col.psum(c, one), one_rep=col.replicate(f, 0, one),
               one_cyc=col.ppermute(i, [(0, 0)], one),
               one_lin=col.ppermute(f, [], one),
               one_gather=col.all_gather(f, one))
    return out


def case_music(inp):
    import torch

    from grbaz_tpu_torch.parallel._collectives import shard
    from grbaz_tpu_torch.parallel.doa import sharded_music_spectrum

    mesh = _mesh(inp["mesh"], ("dev",))
    x = shard(torch.from_numpy(inp["x"]), mesh, "dev")
    steer = shard(torch.from_numpy(inp["steering"]), mesh, "dev")
    return dict(spec=sharded_music_spectrum(x, steer, int(inp["n_sig"]),
                                            mesh))


def case_tp(inp):
    import torch

    from grbaz_tpu_torch.core.stream import Stream
    from grbaz_tpu_torch.parallel.tp import TPFIRDecimator

    mesh = _mesh(inp["mesh"], ("tp",))
    x = torch.from_numpy(inp["x"])
    blk = TPFIRDecimator(inp["taps"], int(inp["decim"]), mesh,
                         dtype=x.dtype)
    step = blk.make_step()
    params = blk.init_params()
    st_s, st_a = blk.init_state(), blk.init_state()
    ys, ya = [], []
    bs = int(inp["block"])
    for k in range(0, x.shape[0], bs):
        st_s, y = step(st_s, params, x[k:k + bs])
        st_a, (o,) = blk.apply(st_a, params, Stream.full(x[k:k + bs]))
        ys.append(y)
        ya.append(o.data[:int(o.count)])
    return dict(y=torch.cat(ys), y_apply=torch.cat(ya), h=params["h"],
                tail=st_s["tail"])


def case_bank(inp):
    import torch

    from grbaz_tpu_torch.parallel._collectives import dim
    from grbaz_tpu_torch.parallel.wbfm_bank import BankConfig, ShardedWBFMBank

    mesh = _mesh(inp["mesh"], ("chan", "time"))
    cfg = BankConfig(**{k: v.item() for k, v in inp.items()
                        if k in BankConfig.__dataclass_fields__})
    bank = ShardedWBFMBank(cfg, mesh)
    state = bank.shard_state(bank.init_state())
    params = bank.init_params(inp["freqs"])
    x_all = torch.from_numpy(inp["x"])
    out = dict(coord=torch.tensor([dim(mesh, "chan")[1],
                                   dim(mesh, "time")[1]]))
    audio = [[] for _ in range(cfg.channels)]
    for b in range(x_all.shape[1] // cfg.block_size):
        blk = x_all[:, b * cfg.block_size:(b + 1) * cfg.block_size]
        state, (a, n) = bank.step(state, params, bank.shard_input(blk))
        for ch, v in enumerate(bank.compact_audio(a, n)):
            audio[ch].append(v)
        out[f"counts_{b}"] = n
        for k, v in state.items():
            out[f"{k}_{b}"] = v
    for ch in range(cfg.channels):
        out[f"audio_{ch}"] = torch.from_numpy(np.concatenate(audio[ch]))
    return out


def _generic_stages():
    """The simple stages of the JAX package's generic pipeline test."""
    import torch

    def s0(st, b):  # running offset += per-microbatch sum
        return st + 1.0, b + st

    def s1(st, b):
        return st, b * 2.0

    def s2(st, b):
        return st + torch.sum(b), b - 1.0

    def s3(st, b):
        return st, b + 0.5
    return [s0, s1, s2, s3]


def _counting(fns, calls):
    def wrap(i, fn):
        def run(st, b):
            calls[i] += 1
            return fn(st, b)
        return run
    return [wrap(i, fn) for i, fn in enumerate(fns)]


def _flat(prefix, tree, out):
    """Tree leaves into ``out`` under ``prefix`` + path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(f"{prefix}.{k}", v, out)
    elif isinstance(tree, (tuple, list)):
        for k, v in enumerate(tree):
            _flat(f"{prefix}.{k}", v, out)
    else:
        out[prefix] = tree


def case_pipeline(inp):
    """The 4-stage WBFM pipeline (chained over two runs, with the squelch
    on quiet and loud input), the generic stages with their states and
    tick counts, and a 2-stage pipeline over a (data, stage) = (2, 2)
    mesh."""
    import torch

    from grbaz_tpu_torch.models.wbfm import WBFMConfig
    from grbaz_tpu_torch.parallel.pipeline import (StagePipeline,
                                                   build_wbfm_pipeline)

    out = {}
    mesh = _mesh((4,), ("stage",))
    n = int(inp["block"])
    for name, sq in (("plain", None), ("squelch", float(inp["squelch_db"]))):
        cfg = WBFMConfig(block_size=n, squelch_db=sq)
        pipe, encode, decode = build_wbfm_pipeline(cfg, mesh)
        runs = ([inp["iq"]] if sq is None
                else [inp["quiet"], inp["loud"]])
        for r, iq in enumerate(runs):
            blocks = iq.reshape(-1, n)
            states = pipe.init_states()
            got = []
            # the plain chain runs as two chained calls of half the blocks
            halves = ([blocks[:len(blocks) // 2], blocks[len(blocks) // 2:]]
                      if sq is None else [blocks])
            for half in halves:
                mb = torch.stack([encode(b) for b in half])
                states, o = pipe.run(states, mb)
                got += [decode(o[m])[0] for m in range(len(half))]
                out[f"{name}{r}_ticks_{len(got)}"] = torch.tensor(pipe.ticks)
            out[f"{name}{r}_audio"] = torch.from_numpy(np.concatenate(got))
            _flat(f"{name}{r}_state", states, out)

    calls = [0] * 4
    pipe = StagePipeline(_counting(_generic_stages(), calls),
                         [np.float32(0)] * 4, (8,), mesh)
    states, o = pipe.run(pipe.init_states(), torch.from_numpy(inp["mb"]))
    out["generic_out"] = o
    _flat("generic_state", states, out)
    out["generic_calls"] = torch.tensor(calls)
    out["generic_ticks"] = torch.tensor(pipe.ticks)

    dp = _mesh((2, 2), ("data", "stage"))
    fns = _generic_stages()
    pipe = StagePipeline([lambda st, b: fns[0](st, b),
                          lambda st, b: fns[2](st, b * 2.0)],
                         [np.float32(0)] * 2, (8,), dp, data_axis="data")
    states = pipe.shard(pipe.init_states(batch=2))
    states, o = pipe.run(states, pipe.shard(torch.from_numpy(inp["mb2"])))
    out["dp_out"] = o
    _flat("dp_state", states, out)
    out["dp_ticks"] = torch.tensor(pipe.ticks)
    return out


CASES = dict(collectives=case_collectives, music=case_music, tp=case_tp,
             bank=case_bank, pipeline=case_pipeline)


def main(argv):
    rank, world, tmp_dir = int(argv[0]), int(argv[1]), argv[2]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp_dir, "rendezvous"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        for name in argv[3:]:
            inp = dict(np.load(os.path.join(tmp_dir, f"{name}.npz")))
            res = CASES[str(inp.pop("case"))](inp)
            np.savez(os.path.join(tmp_dir, f"{name}_{rank}.npz"),
                     **{k: v.numpy() if isinstance(v, torch.Tensor) else v
                        for k, v in res.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
