"""Host PCM output: the last inch from rendered blocks to a playing
instrument.

The reference opens an SDL2 audio device whose callback thread owns the
Tracker and drains a command channel every 1024-sample buffer
(/root/reference/src/main.rs:99-110, src/lib/tracker.rs:314-368).  This
rebuild's analogue is the StreamPump: an audio thread that owns the
tracker, drains marshaled commands at every block boundary, renders
paced against the wall clock with a stated output-latency ring, and
hands landed PCM to a host sink.

Sinks, in preference order:
  * SoundDeviceSink — a real OS audio stream via the `sounddevice`
    package (PortAudio), when importable and a device exists.
  * PCMFileSink — raw float32-LE mono PCM into a path; point it at a
    FIFO and play with e.g. `aplay -f FLOAT_LE -r 44100 -c 1 <fifo>`
    (hosts without PortAudio — including this image, which has no
    /dev/snd).  Writes are naturally paced by the pump.

Device blocks are fetched PER BLOCK with asynchronous host copies
issued at production time: a device-to-host round trip is latency, not
serialization — copies in flight pipeline freely (docs/design.md §6c.8),
and the tracker's lookahead windows start their blocks' copies the
moment the window is computed (tracker._start_host_copies), so the
writer thread's np.asarray at each deadline is a completed-copy read.
That makes the output-latency ring a small CONSTANT independent of the
sync window — 93 ms at 44.1 kHz — instead of a window-batched ring
(sync_interval + 4 blocks).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np


class AudioSink:
    """One mono float32 block sink.  write() may block (backpressure)."""

    def write(self, block: np.ndarray) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class SoundDeviceSink(AudioSink):
    """A real OS audio output via sounddevice/PortAudio (gated import)."""

    def __init__(self, sample_rate: int, block_size: int):
        import sounddevice as sd
        self._stream = sd.OutputStream(
            samplerate=sample_rate, channels=1, dtype="float32",
            blocksize=block_size)
        self._stream.start()

    def write(self, block: np.ndarray) -> None:
        self._stream.write(np.ascontiguousarray(block, np.float32))

    def close(self) -> None:
        try:
            self._stream.stop()
        finally:
            self._stream.close()


# How long `audio start FIFO` waits for a reader to attach before
# giving up with an actionable message (a plain open() would hang the
# REPL thread forever).
FIFO_WAIT_READER_SECS = 5.0


class PCMFileSink(AudioSink):
    """Raw float32-LE mono PCM to a path (FIFO or file), unbuffered.

    A FIFO with no reader would block a plain open() forever — ON THE
    REPL THREAD (`audio start` runs there) — so FIFOs open non-blocking
    with a bounded wait for a reader, then restore blocking writes
    (pacing relies on the pipe's backpressure)."""

    def __init__(self, path, wait_reader_secs: Optional[float] = None):
        import errno
        import fcntl
        import os
        import stat
        self.path = str(path)
        try:
            is_fifo = stat.S_ISFIFO(os.stat(self.path).st_mode)
        except OSError:
            is_fifo = False
        if not is_fifo:
            self._f = open(self.path, "wb", buffering=0)
            return
        if wait_reader_secs is None:
            wait_reader_secs = FIFO_WAIT_READER_SECS
        deadline = time.monotonic() + wait_reader_secs
        while True:
            try:
                fd = os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)
                break
            except OSError as e:
                if e.errno != errno.ENXIO or time.monotonic() >= deadline:
                    raise OSError(
                        f"no reader on FIFO {self.path} — start one first "
                        f"(e.g. aplay -f FLOAT_LE -r 44100 -c 1 "
                        f"{self.path})") from e
                time.sleep(0.05)
        fl = fcntl.fcntl(fd, fcntl.F_GETFL)
        fcntl.fcntl(fd, fcntl.F_SETFL, fl & ~os.O_NONBLOCK)
        self._f = os.fdopen(fd, "wb", buffering=0)

    def write(self, block: np.ndarray) -> None:
        self._f.write(np.asarray(block, "<f4").tobytes())

    def close(self) -> None:
        self._f.close()


class NullSink(AudioSink):
    """Discards audio (pacing/underrun accounting still runs)."""

    def write(self, block: np.ndarray) -> None:
        pass


def open_sink(sample_rate: int, block_size: int,
              pcm_path: Optional[str] = None
              ) -> Tuple[Optional[AudioSink], str]:
    """Best available sink: an explicit PCM path wins, else a real audio
    device when sounddevice can open one, else (None, reason)."""
    if pcm_path:
        try:
            return PCMFileSink(pcm_path), f"raw float32 PCM -> {pcm_path}"
        except OSError as e:
            return None, str(e)
    try:
        sink = SoundDeviceSink(sample_rate, block_size)
        return sink, "sounddevice output stream"
    except Exception as e:
        return None, (f"no audio device ({type(e).__name__}); "
                      "use 'audio start PCM_PATH' for a raw-PCM FIFO")


# The pump/REPL lookahead window.  The pump's output latency is set by
# its RING (below), not by K — so the shipped window MATCHES the ring:
# K=4 halves the window-open rate vs K=2, and with it the speculation-
# miss exposure (a live command discards the prefetched window and the
# replacement's host copy pays one full device round trip;
# docs/design.md §6c.9).  The TRACKER itself holds K=2 (bench.py's
# streaming and soak gates).  Both values await a measurement on the
# H100 (ROADMAP §1 item 6).
STREAM_SYNC_INTERVAL = 4

# The output-latency ring, in blocks — a constant, independent of the
# sync window (per-block async fetches pipeline; design.md §6c.8): 2
# blocks of copy issue-to-use distance + 2 blocks of production/OS
# jitter margin = 93 ms at 44.1 kHz.  bench.py's gated
# pump lane re-proves zero underruns at this ring every round.
RING_BLOCKS = 4


class StreamPump:
    """The audio thread: owns the tracker, paces blocks against the wall
    clock, drains marshaled commands every block (the reference's mpsc
    Command channel into the callback, tracker.rs:321-329), and counts
    underruns (a block handed to the sink after its deadline).

    Output latency contract: block k is due at the sink at
    t0 + (k + 1 + ring) * block_secs, ring = RING_BLOCKS — a measured
    constant (per-block async fetches pipeline; design.md §6c.8).  The producer stays block-paced; the writer
    thread fetches each block (a completed-copy read) and delivers it
    against its deadline.
    """

    def __init__(self, tracker, sink: AudioSink, player=None,
                 on_status: Optional[Callable[[Any], None]] = None,
                 ring: Optional[int] = None):
        self.tracker = tracker
        self.sink = sink
        self.player = player
        self.on_status = on_status
        self.block = tracker.block_size
        self.sample_rate = tracker.sample_rate
        self.block_secs = self.block / self.sample_rate
        # Output latency ring: per-block async fetches make it a small
        # constant independent of the sync window (the lookahead K never
        # adds latency — windows render K blocks in one dispatch, start
        # their host copies immediately, and production stays
        # block-paced).
        self.ring = RING_BLOCKS if ring is None else ring
        self.latency_secs = self.ring * self.block_secs
        self.underruns = 0
        self.blocks_out = 0
        self.worst_late = float("-inf")
        # Delivered-PCM tap for the live dashboard: the writer thread
        # appends each block it hands to the sink (deque ops are
        # GIL-atomic; readers see a consistent recent window).
        self.tap: "collections.deque[np.ndarray]" = \
            collections.deque(maxlen=64)
        # (fn, done, box, cancelled) — see call()/post().
        self._q: "queue.Queue[Tuple[Callable, Optional[threading.Event], List, Optional[threading.Event]]]" \
            = queue.Queue()
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._wq: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._t0 = None
        self.error: Optional[BaseException] = None
        # Compile-stall feedback: while the audio thread sits inside ONE
        # render for longer than stall_note_after seconds (a first
        # compile of a large voice structure), on_stall(waited)
        # fires from the writer thread, then again every
        # stall_note_every seconds until the block lands.  The REPL
        # wires this to a "compiling voice structure..." log line so a
        # silent first play is never mistaken for a dead session.
        self.on_stall: Optional[Callable[[float], None]] = None
        self.stall_note_after = 2.0
        self.stall_note_every = 10.0
        self._busy_since: Optional[float] = None
        self._next_stall_note = float("inf")

    # -- control --------------------------------------------------------

    def start(self) -> None:
        from . import _threads
        # Loop workers: register as a closer (stop() signals and joins)
        # rather than bare tracked threads — a pump left running at
        # interpreter exit must be STOPPED, not joined as-is (it would
        # otherwise pace forever and hold exit for the full join budget).
        _threads.track_closer(self)
        for name, target in (("tuun-audio", self._run),
                             ("tuun-pcm-writer", self._writer)):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        """Shutdown-registry hook (idempotent)."""
        if self._threads:
            self.stop(close_sink=False)

    def stop(self, close_sink: bool = True) -> None:
        self._stop.set()
        self._kick.set()
        for t in self._threads:
            t.join(timeout=30)
        self._threads = []
        if close_sink:
            self.sink.close()

    @property
    def alive(self) -> bool:
        return bool(self._threads) and all(t.is_alive()
                                           for t in self._threads) \
            and not self._stop.is_set()

    def post(self, fn: Callable[[], Any]) -> None:
        """Enqueues `fn` to run on the audio thread at the next block
        boundary (fire-and-forget)."""
        self._q.put((fn, None, [], None))
        self._kick.set()

    def call(self, fn: Callable[[], Any], timeout: float = 120.0,
             progress: Optional[Callable[[float], None]] = None,
             progress_interval: float = 2.0):
        """Runs `fn` on the audio thread and returns its result (or
        re-raises its exception) — the synchronous command surface the
        REPL uses so tracker state is only ever touched on one thread.
        On timeout the command is CANCELLED (the audio thread skips it if
        not yet started) so it cannot double-land after the caller gave
        up on it.  `progress(waited_secs)` fires on the calling thread
        every progress_interval seconds while the command waits (a long
        first compile can hold the audio thread for minutes; the caller
        can tell its user instead of sitting silent)."""
        done = threading.Event()
        cancelled = threading.Event()
        box: List[Any] = []
        self._q.put((fn, done, box, cancelled))
        self._kick.set()
        t0 = time.monotonic()
        while True:
            left = timeout - (time.monotonic() - t0)
            if left <= 0:
                cancelled.set()
                raise TimeoutError(
                    "audio thread did not pick up the command (likely a "
                    "long first compile in flight); the command was "
                    "dropped")
            if done.wait(min(progress_interval, left) if progress
                         else left):
                break
            if progress is not None and not done.is_set():
                try:
                    progress(time.monotonic() - t0)
                except Exception:
                    pass
        if box and isinstance(box[0], BaseException):
            raise box[0]
        return box[0] if box else None

    # -- threads ---------------------------------------------------------

    def _drain_commands(self) -> None:
        while True:
            try:
                fn, done, box, cancelled = self._q.get_nowait()
            except queue.Empty:
                return
            if cancelled is not None and cancelled.is_set():
                continue  # caller timed out and gave up; don't double-land
            try:
                box.append(fn())
            except BaseException as e:  # surfaced at call()
                box.append(e)
            finally:
                if done is not None:
                    done.set()

    def _run(self) -> None:
        try:
            self._run_inner()
        except BaseException as e:  # pragma: no cover - device failures
            self.error = e
            self._stop.set()
            self._wq.put(None)

    def _run_inner(self) -> None:
        tracker = self.tracker
        k = 0
        self._t0 = time.perf_counter()

        while not self._stop.is_set():
            self._drain_commands()
            if self.player is not None:
                self.player.pump()
            # Stall window: a first compile lands inside render_block and
            # can hold this thread for minutes; the writer thread watches
            # _busy_since and fires on_stall notes meanwhile.
            self._next_stall_note = self.stall_note_after
            self._busy_since = time.perf_counter()
            y, status = tracker.render_block()
            self._busy_since = None
            if self.on_status is not None:
                self.on_status(status)
            # Per-block handoff.  Device blocks start their host copy
            # now (window-served blocks already did, at window-open —
            # tracker._start_host_copies; repeating is a no-op), so the
            # writer's np.asarray at the deadline is a completed-copy
            # read, not a ~30 ms round trip (design.md §6c.8).
            if not isinstance(y, np.ndarray):
                try:
                    y.copy_to_host_async()
                except Exception:
                    pass
            self._wq.put((k, y))
            k += 1
            # Pace: block k is produced not earlier than its stream time
            # (the consumer plays it `ring` blocks later).  Wake early
            # for commands — their latency budget is one block.
            target = self._t0 + k * self.block_secs
            while not self._stop.is_set():
                ahead = target - time.perf_counter()
                if ahead <= 0:
                    break
                if self._kick.wait(timeout=min(ahead, self.block_secs)):
                    self._kick.clear()
                    if not self._q.empty():
                        self._drain_commands()
        self._wq.put(None)

    def _maybe_report_stall(self) -> None:
        """Writer-thread side of the compile-stall feedback: fires
        on_stall while one render holds the audio thread."""
        if self.on_stall is None:
            return
        t = self._busy_since
        if t is None:
            return
        waited = time.perf_counter() - t
        if waited >= self._next_stall_note:
            self._next_stall_note = waited + self.stall_note_every
            try:
                self.on_stall(waited)
            except Exception:
                pass

    def _writer(self) -> None:
        while True:
            try:
                item = self._wq.get(
                    timeout=max(self.stall_note_after / 2, 0.05))
            except queue.Empty:
                # Drain until the producer's sentinel (it always lands,
                # even on producer error): blocks already queued at stop
                # still flush.
                self._maybe_report_stall()
                continue
            if item is None:
                return
            k0, packed = item
            try:
                arr = np.asarray(packed, np.float32).reshape(-1, self.block)
            except Exception as e:  # pragma: no cover - device failures
                self.error = e
                self._stop.set()
                return
            for i, row in enumerate(arr):
                deadline = self._t0 + \
                    (k0 + i + 1 + self.ring) * self.block_secs
                try:
                    self.sink.write(row)
                except Exception as e:
                    # A dead sink (FIFO reader gone, device yanked, sink
                    # closed by a timed-out stop) must be VISIBLE in
                    # `audio status`, not a silent thread death.
                    self.error = e
                    self._stop.set()
                    return
                self.tap.append(row)
                late = time.perf_counter() - deadline
                self.worst_late = max(self.worst_late, late)
                if late > 0:
                    self.underruns += 1
                self.blocks_out += 1

    # -- reporting --------------------------------------------------------

    def recent(self, n_samples: int) -> np.ndarray:
        """The most recent <= n_samples of PCM actually delivered to the
        sink (the live dashboard's signal window)."""
        blocks = list(self.tap)
        if not blocks:
            return np.zeros(0, np.float32)
        need = n_samples // self.block + 2
        return np.concatenate(blocks[-need:])[-n_samples:]

    def stats(self) -> dict:
        return {"blocks_out": self.blocks_out,
                "underruns": self.underruns,
                "worst_late_ms": None if self.worst_late == float("-inf")
                else round(self.worst_late * 1e3, 2),
                "latency_ms": round(self.latency_secs * 1e3, 1),
                "alive": self.alive}
