"""Interactive live-coding REPL.

This build's interactive surface (the reference's SDL2 UI loop).  The
REPL is a thin *input handler*: commands are classified into pure
`actions.Action` values (just as sdl2_input.rs classifies keyboard
events), `actions.apply` reduces them against the `AppState`, and
`effects.EffectRunner` executes the returned Effects against the player,
tracker, and evaluator.  `key CHORD...` feeds raw keyboard chords
through `keymap.classify_key`, so the full edit-mode interaction model —
cursor ops, word ops, kill-line, identifier completion cycling,
parameter hints, undo/redo coalescing — is drivable from the prompt.

Without a live audio stream (see `audio start`), time advances
explicitly: `render N.N` renders the next N.N seconds of the mix
(optionally to a WAV), which is where scheduled starts, ramps, and note
releases actually play out.

Run:  python -m tuun_jax.repl [file.tuun]
"""

from __future__ import annotations

import shlex
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from . import actions as A
from . import ir, keymap, optimizer
from .effects import EffectRunner
from .evaluator import Evaluator
from .expr import SliderLinear, TuunError
from .player import Player
from .tracker import Tracker
from .wav import write_wav_f32

DEFAULT_LIBRARY = Path(__file__).resolve().parent / "stdlib" / "v0"


class Repl:
    def __init__(self, sample_rate: int = 44100, tempo: int = 90,
                 beats_per_measure: int = 4, buffer_size: int = 1024,
                 library_root=None, precision: str = "fast",
                 jit: bool = True, out=sys.stdout, precompute: bool = True):
        self.out = out
        self.evaluator = Evaluator(sample_rate, tempo,
                                   library_root or DEFAULT_LIBRARY)
        self.tracker = Tracker(sample_rate, buffer_size,
                               precision=precision, jit=jit, levels=True)
        # Next-measure playback bakes on a worker thread (the reference's
        # precompute thread, main.rs:209-250): `play N measure` returns
        # immediately; `render` pumps finished bakes at block boundaries.
        self.player = Player(self.tracker, tempo, beats_per_measure,
                             precompute=precompute, async_precompute=True)
        self.runner: Optional[EffectRunner] = None
        self.rendered: List[np.ndarray] = []
        self.running = True
        # Live PCM output (audio.StreamPump): when running, it owns the
        # tracker on its audio thread and every command marshals onto it
        # at a block boundary (the reference's mpsc Command channel into
        # the SDL2 callback, tracker.rs:321-329).
        self.pump = None

    # ------------------------------------------------------------------

    @property
    def state(self) -> A.AppState:
        if self.runner is None:
            raise TuunError("no file loaded (use: load FILE)")
        return self.runner.state

    @property
    def programs(self):
        return self.runner.state.programs if self.runner else None

    def log(self, message: str) -> None:
        print(message, file=self.out)

    def dispatch(self, line: str) -> None:
        parts = shlex.split(line.strip())
        if not parts:
            return
        cmd, args = parts[0], parts[1:]
        handler = getattr(self, f"cmd_{cmd}", None)
        if handler is None:
            self.log(f"unknown command: {cmd} (try 'help')")
            return
        try:
            if self.pump is not None and self.pump.alive and \
                    cmd not in ("audio", "quit", "help", "view"):
                # Live audio: the tracker belongs to the audio thread;
                # run the whole command there between blocks.  `view`
                # stays on the REPL thread — it paces its own repaint
                # loop against the wall clock and marshals one per-frame
                # state read instead (running it on the audio thread
                # would stall the block clock for its whole duration).
                # While the command waits (a first compile can hold the
                # audio thread for minutes) the user gets periodic
                # progress instead of a silent prompt.
                last = [None]

                def _waiting(waited):
                    if last[0] is None or waited - last[0] >= 10.0:
                        last[0] = waited
                        self.log(f"audio thread busy {waited:.0f}s — a "
                                 "first compile may be in flight; the "
                                 "command lands when it frees")

                self.pump.call(lambda: handler(*args), progress=_waiting)
            else:
                handler(*args)
        except TuunError as e:
            self.log(f"error: {e}")
        except TimeoutError as e:
            # The audio thread can stall inside a long first compile;
            # pump.call then times out AND cancels
            # the command (it will not double-land).  A stalled audio
            # thread must not tear down the whole live session.
            self.log(f"audio thread busy: {e}")
        except TypeError as e:
            self.log(f"usage error: {e}")
        except (ValueError, IndexError, KeyError) as e:
            # Malformed arguments (non-numeric ints, missing operands,
            # unknown gesture names) must not tear down the live session.
            self.log(f"usage error: {type(e).__name__}: {e} "
                     f"(see 'help' for {cmd} usage)")
        if self.runner is not None and self.runner.state.should_exit:
            self.cmd_quit()

    def run(self) -> None:
        self.log("tuun-jax live session — 'help' for commands")
        while self.running:
            try:
                line = input("tuun> ")
            except EOFError:
                break
            self.dispatch(line)

    # -- commands -------------------------------------------------------

    def cmd_help(self):
        self.log(
            "load FILE [all]      load a program file (all: every binding)\n"
            "list                 list programs\n"
            "select N             select program N (the active program)\n"
            "play N [measure]     play program N (measure: at next measure)\n"
            "loop N M             play program N repeating every M measures\n"
            "stop [N]             stop program N (or everything)\n"
            "keys N               install program N as the keys instrument\n"
            "on KEY [VEL]         strike a key (MIDI note number)\n"
            "off KEY              release a key\n"
            "slider N LABEL V     set a slider (live voices ramp to V)\n"
            "level N DB           set program N's level in dB\n"
            "edit N [TEXT...]     edit program N (no text: interactive "
            "edit mode)\n"
            "key CHORD...         send key chords (enter, escape, C-a, "
            "M-f, M-/, C-z...)\n"
            "type TEXT...         insert text at the edit cursor\n"
            "midi GESTURE...      drive the (simulated) Launchkey: "
            "encoder I D, mode, pads,\n"
            "                     pad top|bottom I, nav, fn, note KEY "
            "[VEL], release KEY, bytes\n"
            "undo N / redo N      undo/redo program N's edits\n"
            "save [FILE]          persist annotations + write source\n"
            "dump N               print program N's optimized waveform IR\n"
            "audio [start [PCM_PATH] | status | stop]\n"
            "                     live audio output: a real device via\n"
            "                     sounddevice when present, else raw\n"
            "                     float32 PCM to PCM_PATH (a FIFO for\n"
            "                     aplay -f FLOAT_LE -r 44100 -c 1)\n"
            "render SECS [FILE]   render the next SECS seconds (to WAV)\n"
            "view [SECS] [FPS]    render with a live scope/spectrum/HUD "
            "frame (terminal renderer)\n"
            "status               voices / pending / marks / mode\n"
            "quit")

    def cmd_load(self, path: str, mode: str = ""):
        source = Path(path).read_text()
        state, message = A.AppState.from_source(
            source, Path(path), all_bindings=mode == "all")
        self.runner = EffectRunner(state, self.evaluator, self.player,
                                   log=self.log)
        if message:
            self.log(message)
        self.cmd_list()

    def cmd_list(self):
        from .sliders import denormalize_or_zero
        ps = self.state.programs
        for i, p in enumerate(ps.programs):
            if p.is_empty():
                continue
            sliders = " ".join(
                f"{c.label}={denormalize_or_zero(c.function, n):.3g}"
                for c, n in zip(p.sliders.configs,
                                p.sliders.normalized_values))
            extra = f"  [{sliders}]" if sliders else ""
            flat = " ".join(p.text.split())
            self.log(f"{ps.display_name(i)}: {flat[:60]}{extra}")

    def _slot(self, name: str) -> int:
        ps = self.state.programs
        name = name.upper()
        if len(name) >= 2 and name[0].isalpha():
            index = (ord(name[0]) - ord("A")) * 8 + int(name[1:]) - 1
        else:
            index = int(name)
        if not (0 <= index < len(ps.programs)) or \
                ps.programs[index].is_empty():
            raise TuunError(f"no program {name}")
        return index

    def cmd_select(self, name: str):
        self.runner.dispatch(A.SelectProgram(self._slot(name)))

    def cmd_play(self, name: str, measure: str = ""):
        index = self._slot(name)
        self.runner.dispatch(A.PlayProgram(
            index, start_at_next_measure=measure == "measure"))

    def cmd_loop(self, name: str, measures: str = "1"):
        index = self._slot(name)
        self.runner.dispatch(A.PlayProgram(
            index, start_at_next_measure=True,
            repeat_after_measures=int(measures)))
        self.log(f"looping {self.state.programs.display_name(index)} "
                 f"every {measures} measures")

    def cmd_stop(self, name: str = ""):
        if not name:
            self.player.stop_all()
            self.log("stopped everything")
            return
        index = self._slot(name)
        self.runner.dispatch(A.RemovePendingProgram(index),
                             A.StopProgram(index))

    def cmd_keys(self, name: str):
        self.runner.dispatch(A.ToggleInstalledKeys(self._slot(name)))

    def cmd_on(self, key: str, velocity: str = "100"):
        if self.state.keys_program is None:
            raise TuunError("no keys instrument (use: keys N)")
        self.runner.dispatch(A.NoteOn(int(key), int(velocity)))
        self.log(f"note on {key}")

    def cmd_off(self, key: str):
        self.runner.dispatch(A.NoteOff(int(key)))
        self.log(f"note off {key}")

    def cmd_slider(self, name: str, label: str, value: str):
        index = self._slot(name)
        program = self.state.programs.programs[index]
        for i, c in enumerate(program.sliders.configs):
            if c.label == label:
                target = float(value)
                # Command values are real units; linear functions invert
                # to a normalized position, user functions take the value
                # as already normalized.
                if isinstance(c.function, SliderLinear):
                    span = c.function.max - c.function.min
                    normalized = (target - c.function.min) / span \
                        if span else 0.0
                else:
                    normalized = target
                self.runner.dispatch(
                    A.SetSliderNormalized(index, i, normalized))
                return
        raise TuunError(f"no slider {label} on program {name}")

    def cmd_level(self, name: str, db: str):
        index = self._slot(name)
        self.runner.dispatch(A.SetLevelDb(index, float(db)))

    def cmd_edit(self, name: str, *text: str):
        index = self._slot(name)
        state = self.state
        if not text:
            # Interactive edit mode on the selected program; drive it
            # with `key` / `type`, leave with `key escape` (evaluates).
            self.runner.dispatch(A.SelectProgram(index), A.EnterEditMode())
            self._show_edit_line()
            return
        # One-shot splice (the scripted-edit surface): swap the text and
        # run the source update effect; record the undo unit on success.
        program = state.programs.programs[index]
        old = program.text
        program.text = " ".join(text)
        before = state.programs.source
        self.runner.run_effect(A.EUpdateSource(index))
        if state.programs.source is before:
            program.text = old  # failed splice: nothing changed
        else:
            state.history(index).record_edit(old, len(old))
            self.runner.invalidate()
            self.log(f"updated {state.programs.display_name(index)}")

    def cmd_key(self, *chords: str):
        if not chords:
            raise TuunError("usage: key CHORD...")
        for chord in chords:
            self.runner.dispatch(*keymap.classify_key(self.state, chord))
        self._show_edit_line()

    def cmd_type(self, *words: str):
        self.runner.dispatch(
            *keymap.classify_text(self.state, " ".join(words)))
        self._show_edit_line()

    def cmd_midi(self, gesture: str = "", *args: str):
        """Drives the Launchkey controller path: gestures become protocol
        bytes on the simulated device, decode through the driver, classify
        into Actions (midi.classify_launchkey), dispatch, and the LED/
        display sync pushes app state back out — the full
        midi_input.rs <-> launchkey.rs loop without hardware."""
        from . import launchkey as lk
        from . import midi
        from .tools.midi_probe import FakeLaunchkey

        if self.runner is None:
            raise TuunError("no file loaded (use: load FILE)")
        if self.runner.launchkey is None or gesture == "connect":
            self._midi_device = FakeLaunchkey()
            self.runner.launchkey = lk.Launchkey(self._midi_device.receive)
            if gesture in ("connect", ""):
                self.log("launchkey connected (simulated)")
                return
        device, driver = self._midi_device, self.runner.launchkey
        port = "daw"
        if gesture == "encoder":
            data = device.turn_encoder(int(args[0]), int(args[1]))
        elif gesture == "mode":
            data = device.switch_encoder_mode(
                lk.MIXER if args[0] == "mixer" else lk.PLUGIN)
        elif gesture == "pads":
            data = device.switch_pad_mode(
                lk.PAD_MODE_DAW if args[0] == "daw" else lk.PAD_MODE_OTHER)
        elif gesture == "pad":
            data = (device.press_top_pad(int(args[1]))
                    if args[0] == "top"
                    else device.press_bottom_pad(int(args[1])))
        elif gesture == "nav":
            data = device.press_nav(args[0])
        elif gesture == "fn":
            data = device.press_function_pad()
        elif gesture == "note":
            port = "midi"
            data = device.play_key(int(args[0]),
                                   int(args[1]) if len(args) > 1 else 100)
        elif gesture == "release":
            port = "midi"
            data = device.play_key(int(args[0]), 0)
        elif gesture == "bytes":
            port = args[0]
            data = bytes(int(b, 16) for b in args[1:])
        else:
            raise TuunError(
                "usage: midi connect | encoder I DELTA | mode plugin|mixer"
                " | pads daw|other | pad top|bottom I | nav next|prev|"
                "next_bank|prev_bank | fn | note KEY [VEL] | release KEY"
                " | bytes daw|midi HEX...")
        event = (driver.feed_daw(data) if port == "daw"
                 else driver.feed_midi(data))
        for ev in driver.drain():
            acts = midi.classify_launchkey(self.state, ev)
            if acts:
                self.runner.dispatch(*acts)
        device.log.clear()
        midi.update_launchkey_state(
            self.state, self.tracker.status_snapshot(), driver,
            now=self.tracker.now,
            keys_candidate=self.runner.keys_candidate)
        self.log(f"-> {event}")
        for line in device.log[-6:]:
            self.log(line)
        self._show_edit_line()

    def _show_edit_line(self):
        state = self.state
        if isinstance(state.mode, A.Edit):
            text = state.active_program().text
            c = state.mode.cursor
            self.log(f"edit {state.programs.display_name(state.active_program_index)}> "
                     f"{text[:c]}│{text[c:]}")
            if state.mode.errors:
                self.log(str(state.mode.errors[0]))

    def cmd_undo(self, name: str):
        self._apply_history(name, "undo")

    def cmd_redo(self, name: str):
        self._apply_history(name, "redo")

    def _apply_history(self, name: str, op: str):
        state = self.state
        index = self._slot(name)
        program = state.programs.programs[index]
        restored = getattr(state.history(index), op)(
            program.text, len(program.text))
        if restored is None:
            self.log(f"nothing to {op}")
            return
        text, _ = restored
        err = state.programs.splice(index, text)
        if err:
            self.log(f"{op} failed: {err}")
        else:
            self.runner.invalidate()
            self.log(f"{op}: {state.programs.display_name(index)} = "
                     f"{text[:50]}")

    def cmd_save(self, path: str = ""):
        ps = self.state.programs
        for w in ps.persist_all():
            self.log(f"warning: {w}")
        ps.save(Path(path) if path else None)
        self.log(f"saved {path or ps.input_path}")

    def cmd_dump(self, name: str):
        index = self._slot(name)
        ev = self.runner.evaluation(index)
        if ev.kind == "waveform":
            self.log(ir.format_waveform(optimizer.optimize(ev.value)))
        elif ev.kind == "keys":
            from .expr import format_expr
            self.log(format_expr(ev.value))
        else:
            self.log("\n".join(str(d) for d in ev.diagnostics))

    def cmd_audio(self, action: str = "start", path: str = ""):
        """Live PCM output.  While running, time advances by itself: play
        a program and hear it — render/view are refused (the audio thread
        is the one consumer of the block stream)."""
        from . import audio
        if action == "start":
            if self.pump is not None:
                if self.pump.alive:
                    self.log("audio already running")
                    return
                # A dead pump (device error, sink gone): reap it first —
                # stop its threads, close its sink, and restore the
                # offline sync cadence — or the restart below would
                # clobber _audio_prev_sync with the already-bumped value
                # and the session could never leave streaming mode.
                self._stop_audio()
            sink, desc = audio.open_sink(self.tracker.sample_rate,
                                         self.tracker.block_size,
                                         pcm_path=path or None)
            if sink is None:
                self.log(f"audio unavailable: {desc}")
                return
            # Live streaming wants deferred syncs (per-block host cost =
            # a buffer handoff); restore the offline default on stop.
            self._audio_prev_sync = self.tracker.sync_interval
            if self.tracker.sync_interval <= 1:
                self.tracker.sync_interval = audio.STREAM_SYNC_INTERVAL
            self.pump = audio.StreamPump(
                self.tracker, sink, player=self.player,
                on_status=(self.runner.observe_status
                           if self.runner is not None else None))
            # Compile-progress feedback: a brand-new voice structure's
            # first compile holds the audio
            # thread inside one render; say so instead of going silent.
            self.pump.on_stall = lambda waited: self.log(
                f"compiling voice structure... {waited:.0f}s (the "
                "persistent cache makes repeats fast)")
            self.pump.start()
            self.log(f"audio started -> {desc} "
                     f"(output latency {self.pump.latency_secs * 1e3:.0f} ms)")
        elif action == "status":
            if self.pump is None:
                self.log("audio not running")
            else:
                s = self.pump.stats()
                self.log(f"audio: {s['blocks_out']} blocks out, "
                         f"{s['underruns']} underruns, worst late "
                         f"{s['worst_late_ms']} ms, latency "
                         f"{s['latency_ms']} ms, alive={s['alive']}")
                if self.pump.error is not None:
                    self.log(f"audio error: {self.pump.error!r}")
        elif action == "stop":
            self._stop_audio(report=True)
        else:
            raise TuunError("usage: audio [start [PCM_PATH]|status|stop]")

    def _stop_audio(self, report: bool = False) -> None:
        if self.pump is None:
            if report:
                self.log("audio not running")
            return
        pump, self.pump = self.pump, None
        pump.stop()
        prev = getattr(self, "_audio_prev_sync", None)
        if prev is not None and prev != self.tracker.sync_interval:
            # Drain deferred bookkeeping before going back to the
            # synchronous offline cadence.
            self.tracker._sync_voices(drain=True)
            self.tracker.sync_interval = prev
        self._audio_prev_sync = None
        if report:
            s = pump.stats()
            self.log(f"audio stopped: {s['blocks_out']} blocks, "
                     f"{s['underruns']} underruns")

    def cmd_render(self, seconds: str, path: str = ""):
        if self.pump is not None and self.pump.alive:
            raise TuunError("audio is live (time advances by itself); "
                            "'audio stop' first")
        n_blocks = max(1, int(float(seconds) * self.tracker.sample_rate /
                              self.tracker.block_size))
        # Wait for outstanding next-measure bakes before rendering: time
        # is virtual here, so unlike the reference's real-time callback
        # (which would catch a late bake up after its fixed start) the
        # deterministic choice is free.  `play` itself stays instant.
        self.player.flush_bakes()
        chunks = []
        status = None
        for _ in range(n_blocks):
            y, status = self.tracker.render_block()
            chunks.append(y)
        if self.runner is not None and status is not None:
            self.runner.observe_status(status)
        mix = np.concatenate(chunks)
        self.rendered.append(mix)
        if path:
            write_wav_f32(path, mix, self.tracker.sample_rate)
            self.log(f"rendered {len(mix)} samples to {path}")
        else:
            peak = float(np.abs(mix).max()) if len(mix) else 0.0
            self.log(f"rendered {len(mix)} samples (peak {peak:.3f}, "
                     f"load {status.tracker_load:.4f})")

    def _dashboard_rows(self):
        """The program-list pane's rows (renderer.rs program list):
        selection, play state, text with the edit cursor, sliders,
        level — built from live app + tracker truth."""
        from . import tui
        from .ids import WaveformId
        from .sliders import denormalize_or_zero
        if self.runner is None:
            return []
        state = self.runner.state
        playing = {v.id for v in self.tracker.active}
        pending = {p.id for p in self.tracker.pending}
        rows = []
        for i, p in enumerate(state.programs.programs):
            if p.is_empty():
                continue
            editing = isinstance(state.mode, A.Edit) and \
                i == state.active_program_index
            wid = WaveformId.program(i)
            rows.append(tui.ProgramRow(
                name=state.programs.display_name(i),
                text=p.text,
                selected=i == state.active_program_index,
                playing=wid in playing,
                pending=wid in pending,
                cursor=state.mode.cursor if editing else None,
                sliders=[(c.label, denormalize_or_zero(c.function, n))
                         for c, n in zip(p.sliders.configs,
                                         p.sliders.normalized_values)],
                level_db=p.level_db,
                error=str(state.mode.errors[0])
                if editing and state.mode.errors else ""))
        return rows

    def _dashboard_frame(self, window: np.ndarray, title: str,
                         color: bool) -> str:
        from . import tui
        sr = self.tracker.sample_rate
        levels = [(v.id, v.level_rms, v.level_peak)
                  for v in self.tracker.active]
        message = ""
        if self.runner is not None:
            mode = type(self.runner.state.mode).__name__
            message = f"mode: {mode}"
            if self.runner.state.message:
                message += "  " + \
                    self.runner.state.message.splitlines()[0]
        return tui.dashboard_frame(
            np.asarray(window, np.float32), sr,
            rows=self._dashboard_rows(), levels=levels,
            load_series=self.tracker.load_metric.series(),
            dispatch_series=self.tracker.dispatch_metric.series(),
            title=title, message=message,
            beat=(self.tracker.now, self.player.tempo,
                  self.player.beats_per_measure),
            color=color)

    def _paint(self, frame: str, painted_lines: int, is_tty: bool) -> int:
        if is_tty and painted_lines:
            print(f"\x1b[{painted_lines}F\x1b[J", end="", file=self.out)
        print(frame, file=self.out)
        return frame.count("\n") + 1

    def cmd_view(self, seconds: str = "1", fps: str = "10"):
        """The live dashboard (the renderer.rs frame, renderer.rs:127):
        program list + cursor + sliders, beat, oscilloscope, spectrum,
        per-voice levels, HUD sparklines — repainted every 1/fps.  With
        live audio running, the view follows the delivered PCM stream
        on the wall clock (the audio thread keeps rendering); offline it
        renders `seconds` of audio like `render` while painting.  On a
        tty the frame repaints in place; otherwise frames print
        sequentially (tests, pipes)."""
        import time as _time
        sr = self.tracker.sample_rate
        block = self.tracker.block_size
        is_tty = getattr(self.out, "isatty", lambda: False)()
        if self.pump is not None and self.pump.alive:
            # Live mode: the audio thread owns the tracker; each frame
            # marshals one state read onto it and draws the tap's PCM.
            # (dispatch() routes commands through pump.call — cmd_view
            # runs ON the audio thread for other commands, but `view`
            # must not: it would stall the block clock, so dispatch
            # special-cases it; see dispatch().)
            pump = self.pump
            duration = float(seconds)
            frame_secs = 1.0 / max(float(fps), 0.01)
            window_n = max(2 * block, int(sr * frame_secs))
            painted = 0
            t_end = _time.monotonic() + duration
            while _time.monotonic() < t_end and pump.alive:
                frame = pump.call(lambda: self._dashboard_frame(
                    pump.recent(window_n),
                    title=f"t={self.tracker.now / sr:6.2f}s  LIVE  "
                          f"underruns {pump.underruns}",
                    color=is_tty))
                painted = self._paint(frame, painted, is_tty)
                _time.sleep(frame_secs)
            return
        n_blocks = max(1, int(float(seconds) * sr / block))
        frame_every = max(1, int(sr / max(float(fps), 0.01) / block))
        self.player.flush_bakes()
        chunks: List[np.ndarray] = []
        status = None
        painted_lines = 0
        painted_upto = 0  # chunks[:painted_upto] already shown
        for i in range(n_blocks):
            y, status = self.tracker.render_block()
            chunks.append(y)
            if (i + 1) % frame_every and i != n_blocks - 1:
                continue
            window = np.concatenate(chunks[painted_upto:])
            painted_upto = len(chunks)
            frame = self._dashboard_frame(
                window, title=f"t={self.tracker.now / sr:6.2f}s  "
                              f"load {status.tracker_load:.3f}",
                color=is_tty)
            painted_lines = self._paint(frame, painted_lines, is_tty)
        if self.runner is not None and status is not None:
            self.runner.observe_status(status)
        self.rendered.append(np.concatenate(chunks))

    def cmd_status(self):
        self.log(f"now = {self.tracker.now} samples "
                 f"({self.tracker.now / self.tracker.sample_rate:.2f}s)")
        for v in self.tracker.active:
            self.log(f"active: {v.id}  rms {v.level_rms:.4f}  "
                     f"peak {v.level_peak:.4f}")
        self.log(f"pending: {[str(p.id) for p in self.tracker.pending]}")
        if self.runner is not None:
            mode = type(self.state.mode).__name__
            self.log(f"mode: {mode}  active: "
                     f"{self.state.programs.display_name(self.state.active_program_index)}")
        load = [x for x in self.tracker.load_metric.series() if x is not None]
        disp = [x for x in self.tracker.dispatch_metric.series()
                if x is not None]
        if load and disp:
            self.log(f"load avg {sum(load) / len(load):.4f}  "
                     f"dispatches/block avg {sum(disp) / len(disp):.1f}")

    def cmd_quit(self):
        self._stop_audio()
        self.player.close()
        self.running = False


def main(argv=None) -> int:
    import os

    from .compile_cache import enable as enable_compile_cache
    enable_compile_cache()
    args = argv if argv is not None else sys.argv[1:]
    repl = Repl()
    if args:
        repl.dispatch(f"load {args[0]}")
    # The rebuild is an instrument: go live immediately when the host
    # has a real audio device (the reference opens SDL2 audio at launch,
    # main.rs:99-110); headless hosts get an informative message and the
    # render/audio-to-FIFO surfaces.
    repl.dispatch("audio start")
    # Pre-warm the stdlib's common voice structures in the background
    # (first compiles are the worst first-user experience; see
    # prewarm.py / bench.py's coldstart lane).  TUUN_PREWARM=0 disables.
    if os.environ.get("TUUN_PREWARM", "1").lower() not in ("0", "off"):
        from . import prewarm
        prewarm.start_background(
            repl.tracker, repl.evaluator,
            on_done=lambda n: repl.log(f"(prewarm: {n} common structures "
                                       "compiled)"))
    repl.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
