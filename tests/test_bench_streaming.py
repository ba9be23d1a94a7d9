"""The streaming bench's live-command injection harness, driven on the
CPU backend: the wall-clock-paced phase must survive the full command
script (note-on, slider ramp, note-off, level change, second note) with
the tracker's lookahead windows engaged — the reference's operating
contract (tracker.rs:321-368 drains commands every callback while never
missing the buffer).  The device gate lives in bench.py main(); this test
pins the harness semantics where they can run deterministically."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402


def test_script_positions_are_ordered_and_gapped():
    pos = bench._script_positions(300, K=16)
    ks = sorted(pos)
    assert [pos[k] for k in ks] == bench.STREAM_SCRIPT
    assert all(b - a >= 16 + 8 for a, b in zip(ks, ks[1:]))
    assert ks[0] >= 16  # never before the first window can even open


def test_paced_streaming_with_injected_commands_cpu():
    # Small K and short paced phase: the harness walk (rehearse ->
    # reset -> paced replay with interrupts) is identical to the device
    # lane; only scale differs.
    sps, misses, max_lat, latencies = bench.bench_streaming(
        n_voices=4, seconds=0.8, block=1024, sync_interval=4,
        paced_seconds=0.5, min_gap=10)
    # Every scripted command fired and was timed.
    assert [name for name, _ in latencies] == bench.STREAM_SCRIPT
    assert all(lat > 0 for _, lat in latencies)
    # Zero misses is the device gate; on the shared CI CPU a couple of
    # blocks may slip — what must hold structurally is that the paced
    # phase completed and commands were audible within the ring budget
    # plus a generous scheduling allowance.
    block_secs = 1024 / bench.SAMPLE_RATE
    assert misses <= 2
    assert max_lat <= (4 + 2) * block_secs + 0.25
    assert sps > 0


def test_injected_commands_change_the_mix():
    # The same command closures, driven unpaced, must actually mutate
    # the voice set: a note-on adds a voice, note-off retires it.
    tracker, play_steady, cmds = bench._streaming_tracker(
        n_voices=4, block=1024, sync_interval=4)
    assert len(tracker.active) == 4
    cmds["note_on"]()
    for _ in range(8):
        y, status = tracker.render_block()
    assert status.voices == 5
    cmds["note_off"]()
    for _ in range(40):
        y, status = tracker.render_block()
    assert status.voices == 4  # the stopped note retired
    # The slider ramp must change the audible mix relative to steady.
    ys = []
    for _ in range(4):
        y, _ = tracker.render_block()
        ys.append(np.asarray(y, np.float32).copy())
    cmds["slider"]()
    y2, _ = tracker.render_block()
    later = []
    for _ in range(4):
        y, _ = tracker.render_block()
        later.append(np.asarray(y, np.float32).copy())
    assert any(np.abs(a).max() > 0 for a in ys)
    # After the ramp (one block), voice 3 is scaled by 0.5/0.8.
    # Just assert the mix is still alive and finite (exact values are
    # covered by the tracker/oracle differential suites).
    assert all(np.isfinite(a).all() for a in later)
    tracker.close()


@pytest.mark.parametrize("K", [2, 4])
def test_interrupted_windows_keep_block_accounting(K):
    # Commands landing mid-window must not skip or double-count blocks:
    # `now` advances exactly one block per render_block call.
    tracker, play_steady, cmds = bench._streaming_tracker(
        n_voices=4, block=1024, sync_interval=K)
    start = tracker.now
    n = 0
    for k in range(6 * K):
        if k == K + 1:
            cmds["note_on"]()
        if k == 3 * K + 1:
            cmds["note_off"]()
        tracker.render_block()
        n += 1
    assert tracker.now - start == n * 1024
    tracker.close()
