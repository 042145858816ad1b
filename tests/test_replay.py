"""`quadjax replay`: paced raw-byte playback of a capture to stdout —
the producer side of the live-pipe story (an addition)."""

import io
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from quadrs_tpu import args as argmod
from quadrs_tpu.serve import run_replay

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
OOK = EXAMPLES / "ook-sim.sr400.cf32"


class _BinStdout:
    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, s):  # text writes (stats go to stderr, not here)
        raise AssertionError("replay must not write text to stdout")

    def flush(self):
        pass

    def fileno(self):
        raise io.UnsupportedOperation


def _replay(monkeypatch, **kw):
    cmd = argmod.ReplayCmd(filename=str(OOK), **kw)
    fake = _BinStdout()
    monkeypatch.setattr(sys, "stdout", fake)
    try:
        rc = run_replay(cmd)
    finally:
        monkeypatch.undo()
    assert rc == 0
    return fake.buffer.getvalue()

def test_unthrottled_bytes_are_the_file(monkeypatch):
    got = _replay(monkeypatch, speed=0.0)
    assert got == OOK.read_bytes()


def test_loop_repeats_the_capture(monkeypatch):
    got = _replay(monkeypatch, speed=0.0, loop=3, chunk=777)
    assert got == OOK.read_bytes() * 3


def test_pacing_takes_real_time(monkeypatch):
    # 800 samples at 400 Hz = 2 s of capture; at 10x that's 0.2 s
    t0 = time.perf_counter()
    got = _replay(monkeypatch, speed=10.0, chunk=100)
    dt = time.perf_counter() - t0
    assert got == OOK.read_bytes()
    n = len(got) // 8
    assert dt >= 0.5 * (n / 400.0 / 10.0)


def test_grammar():
    cmd = argmod.parse("replay -speed 2.5 -loop 4 x.sr1M.cu8".split())[0]
    assert isinstance(cmd, argmod.ReplayCmd)
    assert cmd.speed == 2.5 and cmd.loop == 4
    for bad in ("replay", "replay -speed -1 x.cf32", "replay -loop 0 x.cf32"):
        with pytest.raises(ValueError):
            argmod.parse(bad.split())


def test_replay_pipes_into_a_stdin_consumer(tmp_path):
    # the advertised one-liner: a recorded capture stands in for the
    # radio (two real processes, a real pipe); the consumer's decoded
    # bits must match the direct file run
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/local/bin:/usr/bin:/bin"}
    direct = subprocess.run(
        [sys.executable, "-m", "quadrs_tpu", "ook", "-bit", "16", str(OOK)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert direct.returncode == 0, direct.stderr
    producer = subprocess.Popen(
        [sys.executable, "-m", "quadrs_tpu", "replay", "-speed", "0", str(OOK)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
    )
    piped = subprocess.run(
        [sys.executable, "-m", "quadrs_tpu", "ook", "-bit", "16",
         "-stdin", "yes", "-sr", "400", "-format", "cf32"],
        stdin=producer.stdout, capture_output=True, text=True, env=env,
        timeout=600,
    )
    producer.stdout.close()
    assert producer.wait(timeout=60) == 0
    assert piped.returncode == 0, piped.stderr
    assert piped.stdout == direct.stdout
