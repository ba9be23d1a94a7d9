"""Host PCM output (tuun_jax.audio): the StreamPump owns the tracker on
an audio thread, drains marshaled commands at block boundaries, paces
blocks against the wall clock, and delivers landed PCM to a sink — the
reference's SDL2 audio-callback contract (main.rs:99-110,
tracker.rs:314-368) driven against a fake sink.

Engines run jitted and pre-warmed before going live: eager mode pays an
op-by-op dispatch per block (seconds of wall time), which would swamp
the pacing these tests pin down."""

import io
import time
from pathlib import Path

import numpy as np

from tuun_jax import audio
from tuun_jax.evaluator import Evaluator
from tuun_jax.expr import ESeq
from tuun_jax.ids import MarkId, WaveformId
from tuun_jax.optimizer import optimize
from tuun_jax.player import build_top_level_waveform, stop_ramp
from tuun_jax.tracker import Tracker

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"
SR = 8000
BLOCK = 256
BS = BLOCK / SR


class FakeSink(audio.AudioSink):
    def __init__(self):
        self.blocks = []
        self.times = []
        self.closed = False

    def write(self, block):
        self.blocks.append(np.asarray(block, np.float32).copy())
        self.times.append(time.perf_counter())

    def close(self):
        self.closed = True

    def pcm(self):
        return np.concatenate(self.blocks) if self.blocks else \
            np.zeros(0, np.float32)


def _wave(text):
    ev = Evaluator(SR, 120, STDLIB)
    out = ev.evaluate_source(text, opens=("std",))
    if isinstance(out, ESeq):
        out = out.waveform
    return build_top_level_waveform(optimize(out.waveform), 0.0)


def _tracker(**kw):
    kw.setdefault("precision", "fast")
    kw.setdefault("jit", True)
    return Tracker(SR, BLOCK, **kw)


def test_pump_delivers_the_same_pcm_as_an_offline_render():
    w = _wave("$330 * 0.5")
    tracker = _tracker()
    tracker.play(WaveformId.program(0), w)
    twin = _tracker()
    twin.play(WaveformId.program(0), w)
    # Warm the jitted render path on both (compiles must not land inside
    # the paced phase), keeping the two trackers position-aligned.
    for t in (tracker, twin):
        for _ in range(3):
            t.render_block()
    sink = FakeSink()
    pump = audio.StreamPump(tracker, sink)
    pump.start()
    try:
        time.sleep(20 * BS)
    finally:
        pump.stop()
    assert sink.closed
    assert pump.error is None
    got = sink.pcm()
    assert len(got) >= 12 * BLOCK  # paced: ~1 block per block_secs
    want = []
    for _ in range(len(got) // BLOCK):
        y, _ = twin.render_block()
        want.append(np.asarray(y, np.float32))
    np.testing.assert_allclose(got, np.concatenate(want), atol=1e-6)
    # An idle host with a warm engine never misses its ring deadline.
    assert pump.underruns == 0


def test_pump_paces_against_the_wall_clock():
    sink = FakeSink()
    tracker = _tracker()  # idle: renders host silence
    pump = audio.StreamPump(tracker, sink)
    pump.start()
    try:
        time.sleep(30 * BS)
    finally:
        pump.stop()
    n = len(sink.blocks)
    # Paced production: ~1 block per block_secs of wall time, never an
    # unbounded sprint.
    assert 20 <= n <= 38 + pump.ring
    assert pump.blocks_out == n


def test_ring_is_constant_independent_of_the_sync_window():
    """Per-block async fetches decouple output latency from the sync
    window: a deep lookahead (K=8) must NOT inflate the ring the way the
    old window-batched fetch did (si + 4 blocks).  The delivered PCM
    still matches a plain tracker exactly."""
    w = _wave("$330 * 0.5")
    tracker = _tracker(sync_interval=8)
    tracker.play(WaveformId.program(0), w)
    twin = _tracker()
    twin.play(WaveformId.program(0), w)
    for t in (tracker, twin):
        for _ in range(3):
            t.render_block()
    sink = FakeSink()
    pump = audio.StreamPump(tracker, sink)
    assert pump.ring == audio.RING_BLOCKS
    assert pump.latency_secs == audio.RING_BLOCKS * BS
    pump.start()
    try:
        time.sleep(24 * BS)
    finally:
        pump.stop()
    assert pump.error is None and pump.underruns == 0
    got = sink.pcm()
    assert len(got) >= 16 * BLOCK
    want = []
    for _ in range(len(got) // BLOCK):
        y, _ = twin.render_block()
        want.append(np.asarray(y, np.float32))
    np.testing.assert_allclose(got, np.concatenate(want), atol=1e-6)


def test_commands_marshal_onto_the_audio_thread():
    w = _wave("$330 * 0.5")
    note = _wave("$392 * 0.25")
    # Pre-warm every structure the live phase will touch (including the
    # post-Modify stop-ramp structure) on a scratch tracker: compiled
    # voices are shared process-wide, so the live phase hits caches.
    scratch = _tracker(sync_interval=4)
    scratch.play(WaveformId.program(0), w)
    scratch.play(WaveformId.key(60), note)
    for _ in range(6):
        scratch.render_block()
    scratch.modify(WaveformId.key(60), MarkId.TERMINATOR, stop_ramp())
    for _ in range(30):
        scratch.render_block()
    scratch.close()

    tracker = _tracker(sync_interval=4)
    tracker.play(WaveformId.program(0), w)
    for _ in range(6):
        tracker.render_block()
    sink = FakeSink()
    pump = audio.StreamPump(tracker, sink)
    pump.start()
    try:
        time.sleep(4 * BS)
        # call(): runs on the audio thread, returns the value.
        assert pump.call(lambda: len(tracker.active)) == 1
        pump.call(lambda: tracker.play(WaveformId.key(60), note))
        time.sleep(4 * BS)
        assert pump.call(lambda: len(tracker.active)) == 2
        pump.call(lambda: tracker.modify(
            WaveformId.key(60), MarkId.TERMINATOR, stop_ramp()))
        # The stopped note (50 ms ramp at 8 kHz = 400 samples) retires.
        deadline = time.time() + 120 * BS
        while time.time() < deadline:
            if pump.call(lambda: len(tracker.active)) == 1:
                break
            time.sleep(2 * BS)
        assert pump.call(lambda: len(tracker.active)) == 1
        # Exceptions inside a command surface at the caller.
        try:
            pump.call(lambda: 1 / 0)
            raise AssertionError("expected ZeroDivisionError")
        except ZeroDivisionError:
            pass
    finally:
        pump.stop()
    assert pump.error is None
    assert len(sink.pcm()) >= 8 * BLOCK


def test_pcm_file_sink_roundtrip(tmp_path):
    path = tmp_path / "out.pcm"
    sink = audio.PCMFileSink(path)
    data = np.linspace(-1, 1, 64, dtype=np.float32)
    sink.write(data)
    sink.close()
    back = np.frombuffer(path.read_bytes(), "<f4")
    np.testing.assert_array_equal(back, data)


def test_open_sink_prefers_pcm_path(tmp_path):
    sink, desc = audio.open_sink(SR, BLOCK, pcm_path=str(tmp_path / "a.pcm"))
    assert isinstance(sink, audio.PCMFileSink)
    assert "a.pcm" in desc
    sink.close()


def test_repl_goes_live_and_refuses_offline_renders(tmp_path, monkeypatch):
    from tuun_jax.repl import Repl

    src = tmp_path / "song.tuun"
    src.write_text("open std;\n#{level_db=0}\n_ = $330 * 0.5;\n")
    sink = FakeSink()
    monkeypatch.setattr(audio, "open_sink",
                        lambda sr, bl, pcm_path=None: (sink, "fake sink"))
    out = io.StringIO()
    r = Repl(sample_rate=SR, tempo=60, buffer_size=BLOCK,
             library_root=STDLIB, precision="fast", jit=True, out=out)
    r.dispatch(f"load {src}")
    # Warm the program's compiled path before going live.
    r.dispatch("play A1")
    r.dispatch("render 0.2")
    r.dispatch("audio start")
    try:
        assert "audio started" in out.getvalue()
        assert r.tracker.sync_interval == audio.STREAM_SYNC_INTERVAL
        time.sleep(8 * BS)
        r.dispatch("render 0.1")  # refused while live
        assert "audio is live" in out.getvalue()
        r.dispatch("audio status")
        assert "underruns" in out.getvalue()
    finally:
        r.dispatch("audio stop")
    assert "audio stopped" in out.getvalue()
    assert sink.closed
    # Live audio actually played the program (non-silent PCM landed).
    pcm = sink.pcm()
    assert len(pcm) > 0 and float(np.abs(pcm).max()) > 0.1
    # Offline rendering works again; the sync cadence is restored.
    assert r.tracker.sync_interval == 1
    r.dispatch("render 0.1")
    assert len(r.rendered[-1]) > 0
    r.dispatch("quit")


def test_live_view_paints_from_the_delivered_pcm_tap(tmp_path,
                                                     monkeypatch):
    from tuun_jax.repl import Repl

    src = tmp_path / "song.tuun"
    src.write_text("open std;\n#{level_db=0}\n_ = $330 * 0.5;\n")
    sink = FakeSink()
    monkeypatch.setattr(audio, "open_sink",
                        lambda sr, bl, pcm_path=None: (sink, "fake sink"))
    # Short sync windows: the tap fills one window at a time, and the
    # test should not have to stream 32 blocks before the first flush.
    monkeypatch.setattr(audio, "STREAM_SYNC_INTERVAL", 4)
    out = io.StringIO()
    r = Repl(sample_rate=SR, tempo=60, buffer_size=BLOCK,
             library_root=STDLIB, precision="fast", jit=True, out=out)
    r.dispatch(f"load {src}")
    r.dispatch("play A1")
    r.dispatch("render 0.2")  # warm compiled paths before going live
    r.dispatch("audio start")
    try:
        time.sleep(12 * BS)  # let delivered PCM land in the tap
        r.dispatch("view 0.4 5")
        text = out.getvalue()
        assert "LIVE" in text            # the live dashboard painted
        assert text.count("LIVE") >= 2   # ... more than once
        assert "A1" in text and "measure" in text
        # The tap holds real delivered audio.
        recent = r.pump.recent(4 * BLOCK)
        assert len(recent) > 0 and float(np.abs(recent).max()) > 0.1
        # The audio thread kept pacing during the view (no pile-up of
        # underruns caused by the repaint loop).
        assert r.pump.alive
    finally:
        r.dispatch("audio stop")
    r.dispatch("quit")


def test_fifo_sink_requires_a_reader(tmp_path):
    """A FIFO with no reader must NOT hang `audio start` forever: the
    sink opens non-blocking, waits a bounded time for a reader, then
    fails with an actionable message (review round 4)."""
    import os
    import pytest

    fifo = tmp_path / "pcm.fifo"
    os.mkfifo(fifo)
    t0 = time.perf_counter()
    with pytest.raises(OSError, match="no reader on FIFO"):
        audio.PCMFileSink(fifo, wait_reader_secs=0.2)
    assert time.perf_counter() - t0 < 3.0  # bounded, not forever
    # open_sink surfaces the failure as (None, reason), not a hang.
    sink, desc = audio.open_sink(SR, BLOCK, pcm_path=str(fifo))
    assert sink is None and "no reader" in desc


def test_fifo_sink_streams_to_a_reader(tmp_path, monkeypatch):
    """With a reader attached the FIFO path works end to end, and writes
    are blocking again (pacing relies on pipe backpressure)."""
    import os
    import threading

    monkeypatch.setattr(audio, "FIFO_WAIT_READER_SECS", 5.0)
    fifo = tmp_path / "pcm.fifo"
    os.mkfifo(fifo)
    got = []

    def reader():
        with open(fifo, "rb") as f:
            got.append(f.read(64 * 4))

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    sink = audio.PCMFileSink(fifo)
    data = np.linspace(-1, 1, 64, dtype=np.float32)
    sink.write(data)
    sink.close()
    t.join(timeout=10)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.frombuffer(got[0], "<f4"), data)


def test_call_timeout_cancels_the_command():
    """A timed-out call() must not double-land after the caller gave up
    (the audio thread skips a cancelled entry)."""
    import pytest

    tracker = _tracker()  # idle: renders host silence
    pump = audio.StreamPump(tracker, FakeSink())
    pump.start()
    landed = []
    try:
        # Stall the audio thread's command drain.
        pump.post(lambda: time.sleep(0.6))
        time.sleep(0.05)  # let the stall start
        with pytest.raises(TimeoutError):
            pump.call(lambda: landed.append("x"), timeout=0.1)
        time.sleep(1.0)  # the stall ends; the drain resumes
        assert landed == []  # cancelled: never executed
        # The pump is still healthy and serviceable.
        assert pump.call(lambda: 42) == 42
    finally:
        pump.stop()
    assert pump.error is None


def test_writer_surfaces_sink_errors():
    """A dying sink (FIFO reader gone, device yanked) must be VISIBLE:
    pump.error set, pump no longer alive — not a silent thread death."""

    class DyingSink(audio.AudioSink):
        def __init__(self):
            self.n = 0

        def write(self, block):
            self.n += 1
            if self.n > 2:
                raise ValueError("write to closed file")

    tracker = _tracker()
    pump = audio.StreamPump(tracker, DyingSink())
    pump.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and pump.error is None:
            time.sleep(2 * BS)
        assert isinstance(pump.error, ValueError)
        assert not pump.alive
        assert pump.stats()["alive"] is False
    finally:
        pump.stop()


def test_audio_restart_after_pump_death_restores_cadence(tmp_path,
                                                         monkeypatch):
    """Restarting audio over a DEAD pump must reap it (sink closed,
    offline sync cadence restored) instead of clobbering the saved
    cadence with the already-bumped value — which would leave the
    tracker in deferred-sync streaming mode forever (review round 4)."""
    from tuun_jax.repl import Repl

    src = tmp_path / "song.tuun"
    src.write_text("open std;\n#{level_db=0}\n_ = $330 * 0.5;\n")
    sinks = []

    def fake_open(sr, bl, pcm_path=None):
        sinks.append(FakeSink())
        return sinks[-1], "fake sink"

    monkeypatch.setattr(audio, "open_sink", fake_open)
    out = io.StringIO()
    r = Repl(sample_rate=SR, tempo=60, buffer_size=BLOCK,
             library_root=STDLIB, precision="fast", jit=True, out=out)
    r.dispatch(f"load {src}")
    assert r.tracker.sync_interval == 1
    r.dispatch("audio start")
    assert r.tracker.sync_interval == audio.STREAM_SYNC_INTERVAL
    # The pump dies without an `audio stop` (device error analogue).
    r.pump.stop(close_sink=False)
    assert not r.pump.alive
    r.dispatch("audio start")  # restart reaps the corpse first
    assert sinks[0].closed
    assert r.pump is not None and r.pump.alive
    assert r.tracker.sync_interval == audio.STREAM_SYNC_INTERVAL
    r.dispatch("audio stop")
    # The offline cadence survives the death/restart cycle.
    assert r.tracker.sync_interval == 1
    r.dispatch("quit")


def test_dispatch_survives_a_stalled_audio_thread(tmp_path, monkeypatch):
    """TimeoutError from the audio thread (e.g. a >2 min first compile)
    must be reported, not tear down the live session (review round 4)."""
    from tuun_jax.repl import Repl

    sink = FakeSink()
    monkeypatch.setattr(audio, "open_sink",
                        lambda sr, bl, pcm_path=None: (sink, "fake sink"))
    src = tmp_path / "song.tuun"
    src.write_text("open std;\n#{level_db=0}\n_ = $330 * 0.5;\n")
    out = io.StringIO()
    r = Repl(sample_rate=SR, tempo=60, buffer_size=BLOCK,
             library_root=STDLIB, precision="fast", jit=True, out=out)
    r.dispatch(f"load {src}")
    r.dispatch("audio start")
    try:
        def stalled_call(fn, timeout=120.0, **kw):
            raise TimeoutError("audio thread did not pick up the command")

        monkeypatch.setattr(r.pump, "call", stalled_call)
        r.dispatch("list")
        assert "audio thread busy" in out.getvalue()
        assert r.running  # the session survived
    finally:
        monkeypatch.undo()
        r.dispatch("audio stop")
    r.dispatch("quit")


# -- the real-device sink path, via a module-injected mock sounddevice --
#
# The image has no /dev/snd, so SoundDeviceSink's lines would otherwise
# first run on a user's machine.  A fake `sounddevice` module pins the
# open/write/stop/close sequencing, open_sink's preference order, and a
# mid-stream device error surfacing in `audio status` (the reference's
# SDL2 device open lives at main.rs:99-110).


class _PortAudioError(Exception):
    pass


class _FakeStream:
    def __init__(self, fail_after=None, stop_raises=False, **kw):
        self.kw = kw
        self.started = False
        self.stopped = False
        self.closed = False
        self.writes = []
        self.fail_after = fail_after
        self.stop_raises = stop_raises

    def start(self):
        self.started = True

    def stop(self):
        self.stopped = True
        if self.stop_raises:
            raise _PortAudioError("stream already aborted")

    def close(self):
        self.closed = True

    def write(self, arr):
        if self.fail_after is not None and \
                len(self.writes) >= self.fail_after:
            raise _PortAudioError("device unplugged")
        assert arr.dtype == np.float32 and arr.flags["C_CONTIGUOUS"]
        self.writes.append(np.array(arr))


def _mock_sounddevice(monkeypatch, fail_after=None, broken=False,
                      stop_raises=False):
    import sys
    import types
    mod = types.ModuleType("sounddevice")
    streams = []

    def OutputStream(**kw):
        if broken:
            raise _PortAudioError("no default output device")
        st = _FakeStream(fail_after=fail_after, stop_raises=stop_raises,
                         **kw)
        streams.append(st)
        return st

    mod.OutputStream = OutputStream
    mod.PortAudioError = _PortAudioError
    monkeypatch.setitem(sys.modules, "sounddevice", mod)
    return streams


def test_sounddevice_sink_open_write_close_sequencing(monkeypatch):
    streams = _mock_sounddevice(monkeypatch)
    sink = audio.SoundDeviceSink(SR, BLOCK)
    st = streams[0]
    assert st.kw == {"samplerate": SR, "channels": 1,
                     "dtype": "float32", "blocksize": BLOCK}
    assert st.started
    # Writes land contiguous float32 regardless of the input dtype.
    sink.write(np.arange(BLOCK, dtype=np.float64) / BLOCK)
    sink.write(np.zeros(BLOCK, np.float32))
    assert len(st.writes) == 2
    assert np.allclose(st.writes[0], np.arange(BLOCK) / BLOCK, atol=1e-6)
    sink.close()
    assert st.stopped and st.closed


def test_sounddevice_sink_close_closes_even_when_stop_raises(monkeypatch):
    streams = _mock_sounddevice(monkeypatch, stop_raises=True)
    sink = audio.SoundDeviceSink(SR, BLOCK)
    try:
        sink.close()
    except _PortAudioError:
        pass
    assert streams[0].closed  # the try/finally held


def test_open_sink_prefers_explicit_pcm_path_then_sounddevice(
        monkeypatch, tmp_path):
    streams = _mock_sounddevice(monkeypatch)
    # No path: the real device wins when sounddevice can open one.
    sink, desc = audio.open_sink(SR, BLOCK)
    assert isinstance(sink, audio.SoundDeviceSink)
    assert "sounddevice" in desc
    assert len(streams) == 1
    sink.close()
    # An explicit PCM path wins over an available device.
    sink, desc = audio.open_sink(SR, BLOCK, pcm_path=str(tmp_path / "a.pcm"))
    assert isinstance(sink, audio.PCMFileSink)
    assert len(streams) == 1  # no second device open
    sink.close()


def test_open_sink_reports_reason_when_no_device(monkeypatch):
    _mock_sounddevice(monkeypatch, broken=True)
    sink, desc = audio.open_sink(SR, BLOCK)
    assert sink is None
    assert "_PortAudioError" in desc
    assert "audio start PCM_PATH" in desc  # actionable fallback


def test_device_error_mid_stream_surfaces_in_audio_status(
        tmp_path, monkeypatch):
    """The first minutes on a real host: audio goes live on the
    sounddevice sink, the device dies mid-stream, and `audio status`
    names the error instead of a silent dead thread."""
    from tuun_jax.repl import Repl

    _mock_sounddevice(monkeypatch, fail_after=3)
    src = tmp_path / "song.tuun"
    src.write_text("open std;\n#{level_db=0}\n_ = $330 * 0.5;\n")
    out = io.StringIO()
    r = Repl(sample_rate=SR, tempo=60, buffer_size=BLOCK,
             library_root=STDLIB, precision="fast", jit=True, out=out)
    r.dispatch(f"load {src}")
    r.dispatch("play A1")
    r.dispatch("render 0.2")  # warm the compiled path before going live
    r.dispatch("audio start")
    try:
        assert "audio started -> sounddevice" in out.getvalue()
        deadline = time.time() + 10
        while time.time() < deadline and \
                (r.pump is None or r.pump.error is None):
            time.sleep(BS)
        assert isinstance(r.pump.error, _PortAudioError)
        r.dispatch("audio status")
        text = out.getvalue()
        assert "alive=False" in text
        assert "audio error: _PortAudioError('device unplugged')" in text
    finally:
        r.dispatch("audio stop")
    r.dispatch("quit")


# -- compile-stall / command-wait feedback ------------------------------


def test_stall_notes_fire_while_a_render_holds_the_audio_thread():
    """A first compile holds the audio thread inside one render for up
    to minutes; on_stall must fire periodically meanwhile (the REPL's
    'compiling voice structure...' line) and go quiet once blocks flow."""
    import threading

    tracker = _tracker()
    tracker.play(WaveformId.program(0), _wave("$330 * 0.5"))
    tracker.render_block()  # warm: later blocks are fast
    orig = tracker.render_block
    stall_once = threading.Event()

    def slow_render():
        if not stall_once.is_set():
            stall_once.set()
            time.sleep(0.6)
        return orig()

    tracker.render_block = slow_render
    notes = []
    pump = audio.StreamPump(tracker, FakeSink())
    pump.stall_note_after = 0.1
    pump.stall_note_every = 0.1
    pump.on_stall = notes.append
    pump.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and len(notes) < 2:
            time.sleep(0.02)
        assert len(notes) >= 2, notes
        assert notes == sorted(notes)  # waited grows across notes
        assert notes[0] >= 0.1
        # Once the stall clears, notes stop accumulating.
        time.sleep(0.4)
        n = len(notes)
        time.sleep(0.4)
        assert len(notes) - n <= 1  # at most one in-flight straggler
    finally:
        pump.stop()


def test_call_progress_fires_while_a_command_waits():
    tracker = _tracker()
    tracker.play(WaveformId.program(0), _wave("$330 * 0.5"))
    tracker.render_block()
    pump = audio.StreamPump(tracker, FakeSink())
    pump.start()
    try:
        pump.post(lambda: time.sleep(0.5))  # occupies the audio thread
        waits = []
        got = pump.call(lambda: 42, timeout=10.0,
                        progress=waits.append, progress_interval=0.05)
        assert got == 42
        assert waits and waits == sorted(waits)
        assert waits[-1] >= 0.1  # it really waited behind the sleeper
    finally:
        pump.stop()


def test_repl_logs_compile_progress_while_play_holds_audio(
        tmp_path, monkeypatch):
    """The cold-start gap: a brand-new structure stalls a
    live `play` for the compile with only 'audio thread busy' feedback.
    Now the session says it is compiling, with elapsed seconds."""
    import threading

    from tuun_jax.repl import Repl

    src = tmp_path / "song.tuun"
    src.write_text("open std;\n#{level_db=0}\n_ = $330 * 0.5;\n")
    sink = FakeSink()
    monkeypatch.setattr(audio, "open_sink",
                        lambda sr, bl, pcm_path=None: (sink, "fake sink"))
    out = io.StringIO()
    r = Repl(sample_rate=SR, tempo=60, buffer_size=BLOCK,
             library_root=STDLIB, precision="fast", jit=True, out=out)
    r.dispatch(f"load {src}")
    r.dispatch("play A1")
    r.dispatch("render 0.2")
    r.dispatch("audio start")
    try:
        r.pump.stall_note_after = 0.1
        r.pump.stall_note_every = 0.1
        orig = r.tracker.render_block
        stalled = threading.Event()

        def compile_like_stall():
            if not stalled.is_set():
                stalled.set()
                time.sleep(0.5)
            return orig()

        r.tracker.render_block = compile_like_stall
        deadline = time.time() + 10
        while time.time() < deadline and \
                "compiling voice structure" not in out.getvalue():
            time.sleep(0.02)
        assert "compiling voice structure" in out.getvalue()
    finally:
        r.dispatch("audio stop")
    r.dispatch("quit")
