"""Command-line batch renderer.

Reference-compatible flags (main.rs:33-66) driving the batch path
(main.rs:91-174): parse the input file, evaluate each program, play them on
the tracker, and render blocks until every waveform finishes.  Captures
(`capture("stem")`) stream to float32 WAV files; `--render-out` additionally
dumps the full mixed output.

Extensions over the reference CLI:
  --expr/-p EXPR     render a single expression instead of a file
  --all-bindings     treat every definition as a program (for files like
                     dtmf.tuun that carry no annotations)
  --render-out FILE  write the mixed output to a WAV
  --precision        exact (f64 phase and sequential filters, the
                     reference's semantics) | exact_df (double-single
                     f32 phase, design.md §3b) | fast (production)
  --dump             print each program's waveform IR (the reference's
                     D-key dump)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from . import ir, optimizer
from .evaluator import Evaluator
from .expr import BOpen, SourceBinding
from .ids import WaveformId
from .player import Player
from .programs import ProgramSet
from .tracker import Tracker
from .wav import write_wav_f32

DEFAULT_LIBRARY = Path(__file__).resolve().parent / "stdlib" / "v0"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tuun-jax", description="Tuun batch renderer on JAX")
    p.add_argument("--tempo", type=int, default=90)
    p.add_argument("--beats_per_measure", type=int, default=4)
    p.add_argument("--sample_rate", type=int, default=44100)
    p.add_argument("--buffer_size", type=int, default=1024)
    p.add_argument("--date_format", default="_%Y-%m-%d_%H-%M-%S")
    p.add_argument("--precompute", default="true",
                   choices=["true", "false"])
    p.add_argument("--ui", default="false", choices=["true", "false"],
                   help="accepted for reference-CLI compatibility; only "
                        "batch (non-UI) mode exists in this build")
    p.add_argument("--library_root", type=Path, default=None)
    p.add_argument("input_file", nargs="?", default=None)
    p.add_argument("-O", "--output_dir", default=".")
    # Extensions over the reference CLI
    p.add_argument("-p", "--expr", default=None,
                   help="render this expression instead of an input file")
    p.add_argument("--open", action="append", default=None, dest="opens",
                   help="modules to open for --expr (default: std)")
    p.add_argument("--all-bindings", action="store_true")
    p.add_argument("--render-out", default=None)
    p.add_argument("--duration", type=float, default=600.0,
                   help="maximum seconds to render")
    p.add_argument("--precision", default="fast",
                   choices=["fast", "exact", "exact_df"])
    p.add_argument("--no-jit", action="store_true")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="JAX backend to run on (default: JAX's own "
                        "choice, the GPU when there is one)")
    p.add_argument("--dump", action="store_true")
    p.add_argument("--quiet", action="store_true")
    return p


def resolve_library_root(args) -> Path:
    if args.library_root is not None:
        return args.library_root
    local = Path("./lib/v0")
    if local.is_dir():
        return local
    return DEFAULT_LIBRARY


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    from .compile_cache import enable as enable_compile_cache
    enable_compile_cache()
    if args.platform is not None:
        import jax
        jax.config.update("jax_platforms", args.platform)
        # If main() was called after the backend initialized, the update
        # above has no effect — fail loudly instead.
        try:
            backend = jax.default_backend()
        except RuntimeError as e:  # no such device on this machine
            print(f"error: --platform {args.platform}: {e}", file=sys.stderr)
            return 2
        if backend != args.platform:
            print(f"error: --platform {args.platform} requested but the "
                  f"JAX backend is already initialized as '{backend}' "
                  f"(invoke via `python -m tuun_jax` so the platform is "
                  f"applied before import)", file=sys.stderr)
            return 2
    if args.input_file is None and args.expr is None:
        print("error: provide an input file or --expr", file=sys.stderr)
        return 2

    if args.ui == "true":
        # The interactive surface of this build is the live-coding REPL
        # (the reference's --ui launches its SDL2 window).
        from .repl import Repl
        repl = Repl(sample_rate=args.sample_rate, tempo=args.tempo,
                    beats_per_measure=args.beats_per_measure,
                    buffer_size=args.buffer_size,
                    library_root=resolve_library_root(args),
                    precision=args.precision, jit=not args.no_jit)
        if args.input_file:
            repl.dispatch(f"load {args.input_file}")
        repl.run()
        return 0

    log = (lambda *a: None) if args.quiet else print
    library_root = resolve_library_root(args)
    evaluator = Evaluator(args.sample_rate, args.tempo, library_root)
    tracker = Tracker(
        args.sample_rate, args.buffer_size,
        captured_output_dir=args.output_dir,
        captured_date_format=args.date_format,
        precision=args.precision, jit=not args.no_jit,
        # Pipeline blocks between host syncs on the jitted path.
        sync_interval=16 if not args.no_jit else 1)
    player = Player(tracker, args.tempo, args.beats_per_measure,
                    precompute=args.precompute == "true")

    played = 0
    if args.expr is not None:
        opens = tuple(args.opens) if args.opens else ("std",)
        try:
            value = evaluator.evaluate_source(args.expr, opens=opens)
        except Exception as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        from .expr import ESeq, EWaveform
        if isinstance(value, ESeq):
            value = value.waveform
        if not isinstance(value, EWaveform):
            print("Error: expression did not evaluate to a waveform",
                  file=sys.stderr)
            return 1
        w = value.waveform
        if args.dump:
            print(ir.format_waveform(optimizer.optimize(w)))
        log("Playing expression")
        player.play(WaveformId.program(0), w)
        played += 1
    elif args.input_file.endswith(".tuunp"):
        # A program-list file (like fm-variations.tuunp): one expression
        # per line, `//` comments and blank lines skipped.
        try:
            lines = Path(args.input_file).read_text().split("\n")
        except OSError as e:
            print(f"Failed to read input_file: {e}", file=sys.stderr)
            return 1
        from .expr import ESeq, EWaveform
        opens = tuple(args.opens) if args.opens else ("std",)
        for lineno, line in enumerate(lines, 1):
            text = line.strip()
            if not text or text.startswith("//"):
                continue
            try:
                value = evaluator.evaluate_source(text, opens=opens)
            except Exception as e:
                print(f"{args.input_file}:{lineno}: Error: {e}",
                      file=sys.stderr)
                continue
            if isinstance(value, ESeq):
                value = value.waveform
            if not isinstance(value, EWaveform):
                log(f"line {lineno} did not evaluate to a waveform")
                continue
            log(f"Playing line {lineno}: {text[:60]}")
            if args.dump:
                print(ir.format_waveform(optimizer.optimize(value.waveform)))
            player.play(WaveformId.program(lineno), value.waveform)
            played += 1
    else:
        try:
            source = Path(args.input_file).read_text()
        except OSError as e:
            print(f"Failed to read input_file: {e}", file=sys.stderr)
            return 1
        program_set, message = ProgramSet.from_source(
            source, Path(args.input_file), all_bindings=args.all_bindings)
        log("Starting in non-UI mode")
        if message:
            print(message)
        for index, program in enumerate(program_set.programs):
            if program.is_empty():
                continue
            name = program_set.display_name(index)
            log(f"Playing program {name}: {program.text}")
            bindings = [SourceBinding(BOpen(("__prelude",)))]
            bindings += [SourceBinding(BOpen(tuple(o.split("."))))
                         for o in (args.opens or [])]
            bindings += program_set.evaluation_bindings(index)
            try:
                from . import eval as eval_mod, parser
                from .diagnostics import Source
                from .expr import ESeq, EWaveform
                expr = parser.parse_program(program.text, Source.program())
                value = eval_mod.evaluate(evaluator.resolve, bindings, expr)
            except Exception as e:
                diag = evaluator.diagnose(
                    e, program_text=program.text, file_text=source) \
                    if hasattr(e, "span") else None
                print(f"Error: {diag if diag else e}", file=sys.stderr)
                return 1
            if isinstance(value, ESeq):
                value = value.waveform
            if not isinstance(value, EWaveform):
                log(f"Program {name} did not evaluate to a waveform")
                continue
            if args.dump:
                print(ir.format_waveform(optimizer.optimize(value.waveform)))
            player.play(WaveformId.program(index), value.waveform,
                        level_db=program.level_db,
                        sliders=program.sliders.configs,
                        normalized=program.sliders.normalized_values)
            played += 1

    if played == 0:
        log("Nothing to play")
        return 0

    chunks = []
    sink = chunks.append if args.render_out else None
    mixed = tracker.run_to_completion(max_seconds=args.duration, sink=sink)
    # Voices still running at the duration cap (infinite programs): stop
    # them so captures flush to their WAV files.
    tracker.stop_all()
    # Deferred syncs render whole windows past the last voice.  When every
    # voice's length was statically known the tracker knows the exact final
    # sample — trim to it; otherwise fall back to the trailing-silence
    # heuristic (keep one buffer of padding).
    end = tracker.known_end
    if end:
        mixed = mixed[:min(len(mixed), end)]
    else:
        nz = np.nonzero(mixed)[0]
        if len(nz):
            mixed = mixed[:min(len(mixed),
                               int(nz[-1]) + 1 + args.buffer_size)]
    log(f"All waveforms finished ({len(mixed)} samples, "
        f"{len(mixed) / args.sample_rate:.2f}s)")
    if args.render_out:
        write_wav_f32(args.render_out, mixed, args.sample_rate)
        log(f"Wrote {args.render_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
