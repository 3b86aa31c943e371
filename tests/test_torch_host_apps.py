"""The port's host apps (``grbaz_tpu_torch/apps/{control_loop_calc,gpsdo,
pps_diff,convert}.py``) pass the JAX package's tests, and agree with the
JAX apps.

The first section repeats the control-loop, GPSDO and PPS tests of
``tests/test_apps.py`` on the port's copies (no array work: these apps
take no ``--device``). The second runs each app of both packages on the
same arguments: ``convert`` writes the same bytes for every pair of
formats, ``control_loop_calc`` prints the same, ``parse_gps_servo``
decodes the same fields.
"""

import numpy as np
import pytest


# -------------------------------------------------------------------------
# tests/test_apps.py:10, :81, :98 on the port's copies
# -------------------------------------------------------------------------

def test_control_loop_calc(capsys):
    from grbaz_tpu_torch.apps.control_loop_calc import (alpha_beta_to_bw_damping,
                                                  bw_damping_to_alpha_beta,
                                                  main)
    # roundtrip: bw/damping -> alpha/beta -> bw/damping
    a, b = bw_damping_to_alpha_beta(0.0628, 0.707)
    bw, d = alpha_beta_to_bw_damping(a, b)
    assert bw == pytest.approx(0.0628, rel=1e-6)
    assert d == pytest.approx(0.707, rel=1e-6)
    assert main(["-l", "0.0628", "-d", "0.707"]) == 0
    out = capsys.readouterr().out
    assert "Alpha" in out and "Beta" in out
    assert main([]) == 1  # no args -> usage error


def test_gpsdo_app(capsys, tmp_path):
    from grbaz_tpu_torch.apps.gpsdo import main, parse_gps_servo
    fifo = tmp_path / "gps.txt"
    assert main(["-n", "6", "-i", "0.01", "-f", str(fifo)]) == 0
    out = capsys.readouterr().out
    assert "lock state -> Locked, and GPS active" in out
    assert "health -> healthy" in out
    assert "drift:" in out and "lock transitions" in out
    assert len(fifo.read_text().strip().splitlines()) == 6

    servo = parse_gps_servo("40000 31873.2 -4.5 2.1e-12 11 9 5 0x14")
    assert servo["lock_state_str"].startswith("Holdover, but still")
    assert servo["sats_visible"] == 11 and servo["sats_tracked"] == 9
    assert "GPS in holdover > 60 s" in servo["health_flags"]
    assert "phase offset to UTC > 250 ns" in servo["health_flags"]


def test_pps_diff_app(capsys):
    from grbaz_tpu_torch.apps.pps_diff import main
    assert main(["-n", "5"]) == 0
    out = capsys.readouterr().out
    assert out.count("diff") >= 5
    assert "drift" in out



# -------------------------------------------------------------------------
# the port's apps against the JAX package's
# -------------------------------------------------------------------------

FORMATS = ("u8", "i8", "i16", "f32", "c64")


@pytest.mark.parametrize("dst", FORMATS + ("text",))
@pytest.mark.parametrize("src", FORMATS)
def test_convert_equals_jax(tmp_path, src, dst):
    from grbaz_tpu.apps import convert as jconvert
    from grbaz_tpu_torch.apps import convert
    rng = np.random.default_rng(len(src) * 7 + len(dst))
    blob = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    if src in ("f32", "c64"):   # finite values within the integer ranges
        x = rng.uniform(-1, 1, 1024).astype(np.float32)
        blob = x.tobytes()
    inp = tmp_path / "in.bin"
    inp.write_bytes(blob)
    outs = []
    for mod, name in ((convert, "port"), (jconvert, "jax")):
        out = tmp_path / name
        assert mod.main([str(inp), str(out), "--from", src, "--to", dst,
                         "--limit", "600"]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 0


def test_convert_sign2unsigned_equals_jax(tmp_path):
    from grbaz_tpu.apps import convert as jconvert
    from grbaz_tpu_torch.apps import convert
    inp = tmp_path / "s8.bin"
    inp.write_bytes(np.arange(-128, 128, dtype=np.int8).tobytes())
    outs = []
    for mod, name in ((convert, "port"), (jconvert, "jax")):
        out = tmp_path / name
        assert mod.main([str(inp), str(out), "--from", "i8", "--to",
                         "sign2unsigned"]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == bytes(range(256))


@pytest.mark.parametrize("argv", [["-l", "0.0628", "-d", "0.707"],
                                  ["-a", "0.1", "-b", "0.005"],
                                  ["-a", "0.1", "-d", "0.707"], []])
def test_control_loop_calc_equals_jax(capsys, argv):
    from grbaz_tpu.apps import control_loop_calc as jcalc
    from grbaz_tpu_torch.apps import control_loop_calc as calc
    rc = calc.main(argv)
    port = capsys.readouterr()
    assert rc == jcalc.main(argv)
    jax_ = capsys.readouterr()
    assert (port.out, port.err) == (jax_.out, jax_.err)


@pytest.mark.parametrize("line", [
    "40000 31873.2 -4.5 2.1e-12 11 9 5 0x14",
    "12 31000.0 0.3 1e-13 8 8 0 0x0",
    "7 30000 12.0 -3e-11 3 1 2 0x3"])
def test_parse_gps_servo_equals_jax(line):
    from grbaz_tpu.apps.gpsdo import parse_gps_servo as jparse
    from grbaz_tpu_torch.apps.gpsdo import parse_gps_servo
    assert parse_gps_servo(line) == jparse(line)
