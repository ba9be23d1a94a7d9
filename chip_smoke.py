"""Proves that the synthesiser's main paths run and are right on one GPU.

    python chip_smoke.py              # phases a-e on one card
    python chip_smoke.py --devices 4  # only phase f, on four cards

Phases, each printed with its verdict and seconds:
  a  the default JAX device is a GPU (prints the card's name and power
     limit as nvidia-smi gives them);
  b  examples/song.tuun rendered by the CLI at 32768-sample blocks in fast
     precision: the WAV and the capture("bell") stem are finite and not
     silent, and every program rendered through the CLI's Player and
     Tracker agrees with the per-sample oracle (oracle.py) under the
     per-class tolerances of tools/web_checker.py;
  c  the filter voices (bench.py's three IIR cells and a biquad) at
     2^20-lane blocks in fast precision, against the oracle at the strict
     bound of bench.SHAPE_TOL["filter"]: the path of the affine-scan
     kernel;
  d  strict semantics on the card: the NCO sign rule behind the analytic
     Reset tier at all 2^24 grid angles; bench.py's production-shape programs
     at 2^17 samples and seeded fuzzgen programs in exact precision (f64)
     against the oracle at atol 1e-5, and again in exact_df at
     bench.SHAPE_TOL;
  e  a live TuunSession(44100, 1024) playing pm_piano_keys: 16 note-ons
     and note-offs and one slider command over 1000 blocks, against the
     native C++ tracker replaying the same schedule, with no warning that
     donated buffers went unused;
  f  (--devices 4 only) __graft_entry__.dryrun_multichip on four GPUs.

The last line of standard output is one JSON object, {"ok": true, "device":
{...}}, printed only when every phase passed; the exit code is 0 then and 1
otherwise.  Run it from the repository root.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent
SAMPLE_RATE = 44100


class PhaseFailed(Exception):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise PhaseFailed(message)


def phase_device(want: int):
    """a: the default device is a GPU, and there are `want` of them."""
    import jax

    devices = jax.devices()
    dev = devices[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = f"nvidia-smi unavailable ({e})"
    print(f"card: {card}", flush=True)
    check(dev.platform == "gpu",
          f"default device is {dev.platform} ({dev.device_kind}), not gpu")
    check(len(devices) >= want, f"{len(devices)} GPUs, need {want}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def _recording_plays(tracker_cls):
    """Patches tracker_cls.play to log every (waveform, start) it is
    given; returns (log, undo)."""
    log = []
    orig = tracker_cls.play

    def play(self, wid, waveform, start=None, repeat_every=None):
        log.append((wid, waveform, self.now if start is None else start))
        return orig(self, wid, waveform, start, repeat_every)

    tracker_cls.play = play
    return log, lambda: setattr(tracker_cls, "play", orig)


def phase_song():
    """b: the song through the CLI, and each program against the oracle."""
    import numpy as np

    from tuun_jax import cli, oracle
    from tuun_jax.tools.web_checker import diff_against_reference
    from tuun_jax.tracker import Tracker
    from tuun_jax.wav import read_wav

    block = 32768
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    wav = out / "song.wav"
    plays, undo = _recording_plays(Tracker)
    try:
        rc = cli.main([str(HERE / "examples" / "song.tuun"),
                       "--buffer_size", str(block), "--precision", "fast",
                       "--render-out", str(wav), "-O", str(out),
                       "--date_format", "", "--quiet"])
    finally:
        undo()
    check(rc == 0, f"cli exit code {rc}")
    check(len(plays) >= 4, f"{len(plays)} programs played")
    for path, what in ((wav, "mix"), (out / "bell.wav", "bell stem")):
        check(path.exists(), f"no {what} WAV")
        y, sr = read_wav(str(path))
        check(sr == SAMPLE_RATE, f"{what} sample rate {sr}")
        check(len(y) > SAMPLE_RATE, f"{what} has {len(y)} samples")
        check(bool(np.all(np.isfinite(y))), f"{what} is not finite")
        rms = float(np.sqrt(np.mean(np.square(y, dtype=np.float64))))
        check(rms > 1e-3, f"{what} is silent (rms {rms:.2e})")
    ends = []
    for wid, w, start in plays:
        t = Tracker(SAMPLE_RATE, block, precision="fast",
                    captured_output_dir=str(out / "alone"),
                    captured_date_format="", sync_interval=16)
        t.play(wid, w, start=0)
        got = t.run_to_completion(max_seconds=60.0)
        ref = oracle.render(w, len(got), SAMPLE_RATE)
        # Whole blocks render past a voice's end: that tail is silence.
        check(not np.any(got[len(ref):]), f"program {wid}: sound past "
              f"its end at sample {len(ref)}")
        err = diff_against_reference(got[:len(ref)], ref, [w])
        check(not err, f"program {wid}: {err}")
        ends.append(start + len(ref))
    print(f"  song: {len(plays)} programs, {len(y)} stem samples, "
          f"programs end by sample {max(ends)}", flush=True)


def phase_filters():
    """c: the filter voices at 2^20-lane blocks against the oracle."""
    import numpy as np

    import bench
    from tuun_jax import engine, oracle
    from tuun_jax.tools.scan_bench import filter_cells

    block = 1 << 20
    n = block + block // 2  # a full block, then a carried partial one
    tol = bench.SHAPE_TOL["filter"]
    for name, w in filter_cells().items():
        got = np.asarray(engine.render(w, n, SAMPLE_RATE, precision="fast",
                                       block=block), np.float64)
        ref = np.asarray(oracle.render(w, n, SAMPLE_RATE), np.float64)
        check(len(got) == len(ref), f"{name}: length {len(got)} != "
              f"{len(ref)}")
        # filter_1_1_linear's feedback coefficient -0.5 + 0.5 t leaves the
        # unit circle at t = 3 s; from there on the filter is unstable and
        # amplifies any rounding difference without bound.
        m = 3 * SAMPLE_RATE if name == "filter_1_1_linear" else len(ref)
        err = float(np.max(np.abs(got[:m] - ref[:m])))
        scale = max(1.0, float(np.max(np.abs(ref[:m]))))
        check(err <= tol * scale, f"{name}: max err {err:.3e} > "
              f"{tol:.0e} * {scale:.3g}")
        print(f"  {name}: {m} of {n} samples, max err {err:.3e} "
              f"(scale {scale:.3g})", flush=True)


# Seeds of tests/test_fuzz.py's engine-vs-oracle bank whose programs are
# well conditioned and 24 samples long at its 4 Hz sample rate.
FUZZ_SEEDS = (3, 5, 6, 7, 8, 9)


def phase_strict():
    """d: exact (f64) and exact_df on the card against the oracle."""
    import numpy as np

    import bench
    from tuun_jax import engine, fuzzgen, oracle

    # (name, waveform, samples, rate, block, SHAPE_TOL class, seed,
    # oracle block): fuzz programs compare with the oracle generating in
    # the same blocks, as tests/test_fuzz.py does (non-const filter
    # coefficients are generated per window).
    cases = [(f"shape/{k}", w, 1 << 17, SAMPLE_RATE, block, k, 0, 0)
             for k, w in bench._shape_programs().items()
             for block in (1 << 17, 1024)]
    cases += [(f"fuzz/{seed}", fuzzgen.random_waveform(
                  random.Random(seed), depth=3), 24, 4, block, None, seed,
               block)
              for seed in FUZZ_SEEDS for block in (3, 8, 32)]
    # The analytic Reset tier's premise, on this card's f32 sin: for every
    # one of the 2^24 NCO grid angles, sin >= 0 exactly when the phase is
    # below half a turn (CReset's class doc).
    import jax
    import jax.numpy as jnp

    from tuun_jax.engine.graph import _nco_angle

    def sign_rule_breaks():
        ph = jnp.arange(1 << 24, dtype=jnp.uint32) << jnp.uint32(8)
        pos = jnp.sin(_nco_angle(ph)) >= 0
        return jnp.sum(pos != (ph < jnp.uint32(1 << 31)))

    breaks = int(jax.jit(sign_rule_breaks)())
    check(breaks == 0, f"NCO sign rule fails at {breaks} grid angles")
    print("  NCO sign rule holds at all 2^24 grid angles", flush=True)
    for precision in ("exact", "exact_df"):
        worst = 0.0
        for name, w, n, sr, block, cls, seed, oblock in cases:
            ref = np.asarray(oracle.render(w, n, sr, seed=seed,
                                           block=oblock), np.float64)
            got = np.asarray(engine.render(w, n, sr, precision=precision,
                                           seed=seed, block=block),
                             np.float64)
            check(len(got) == len(ref),
                  f"{precision} {name}: length {len(got)} != {len(ref)}")
            check(bool(np.all(np.isfinite(got))),
                  f"{precision} {name}: non-finite samples")
            d = np.abs(got - ref)
            err = float(d.max()) if len(d) else 0.0
            if precision == "exact":
                bound = 1e-5 + 1e-5 * np.abs(ref)
            else:
                tol = bench.SHAPE_TOL[cls] if cls else max(
                    bench.SHAPE_TOL.values())
                bound = tol * max(1.0, float(np.abs(ref).max()))
            check(bool(np.all(d <= bound)),
                  f"{precision} {name} (block {block}): max err {err:.3e}")
            worst = max(worst, err)
        print(f"  {precision}: {len(cases)} renders, worst abs err "
              f"{worst:.3e}", flush=True)


def _splice(w, mark, new, at_seconds):
    """`w` with the content under `mark` replaced by `new` from
    `at_seconds` on: the waveform a Modify at that moment leaves behind,
    for a renderer that cannot modify."""
    from tuun_jax import ir

    def go(x):
        if isinstance(x, ir.Marked):
            if x.id == mark:
                head = ir.Fin(ir.BinaryPointOp(ir.Operator.SUBTRACT,
                                               ir.Time(),
                                               ir.Const(at_seconds)),
                              x.waveform)
                return ir.Marked(x.id, ir.Append(head, new))
            return ir.Marked(x.id, go(x.waveform))
        kids = x.children()
        return x.replace_children(tuple(go(k) for k in kids)) if kids else x

    return go(w)


def phase_session():
    """e: a live keys session against the native tracker."""
    import numpy as np

    from tuun_jax import native
    from tuun_jax.session import TuunSession
    from tuun_jax.tools.web_checker import diff_against_reference

    block, n_blocks = 1024, 1000
    s = TuunSession(SAMPLE_RATE, block_size=block, precision="fast")
    check(s.install("pm_piano_keys", sliders='["level:0.5:0:1"]',
                    opens=("std", "pm_synth")) == "keys",
          "pm_piano_keys did not install as keys")
    tracker = s.tracker
    # Sample positions in the session's output: the tracker's clock stops
    # while nothing plays (process() then returns None: silence here).
    voices = []  # [waveform, start, [(mark, new, at)]]
    live = {}
    chunks = []
    orig_play, orig_modify = tracker.play, tracker.modify

    def play(wid, waveform, start=None, repeat_every=None):
        delay = 0 if start is None else start - tracker.now
        live[wid] = [waveform, block * len(chunks) + delay, []]
        voices.append(live[wid])
        return orig_play(wid, waveform, start, repeat_every)

    def modify(wid, mark, new):
        if wid in live:
            live[wid][2].append((mark, new, block * len(chunks)))
        return orig_modify(wid, mark, new)

    tracker.play, tracker.modify = play, modify
    ons = {10 + 60 * i: 60 + (7 * i) % 24 for i in range(16)}
    offs = {b + 35: k for b, k in ons.items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for b in range(n_blocks):
            if b in ons:
                s.note_on(ons[b], 100)
            if b in offs:
                s.note_off(offs[b])
            if b == 500:
                s.update_slider("level", 0.9)
            y = s.process()
            chunks.append(np.zeros(block, np.float32) if y is None else y)
    donated = [str(w.message) for w in caught
               if "donated" in str(w.message).lower()]
    check(not donated, f"donation warning: {donated[0] if donated else ''}")
    got = np.concatenate(chunks)
    check(len(voices) == 16, f"{len(voices)} voices played")
    nt = native.NativeTracker(SAMPLE_RATE)
    played = []
    for w, start, mods in voices:
        for mark, new, at in mods:
            # Half a sample early: the cut lands on the sample boundary
            # whatever the rounding of at / sample_rate.
            w = _splice(w, mark, new, (at - start - 0.5) / SAMPLE_RATE)
        nt.play(w, start=start, seed=0)
        played.append(w)
    ref, _ = nt.render(len(got))
    err = diff_against_reference(got, ref, played)
    check(not err, f"session vs native tracker: {err}")
    print(f"  session: {n_blocks} blocks, {len(voices)} notes, "
          f"{sum(len(m) for _, _, m in voices)} modifies", flush=True)


def phase_mesh():
    """f: the meshed tracker paths on four cards against one device."""
    sys.path.insert(0, str(HERE))
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 runs only the four-card mesh phase")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    phases = [("a device", lambda: phase_device(args.devices))]
    if args.devices == 4:
        phases.append(("f mesh", phase_mesh))
    else:
        phases += [("b song", phase_song), ("c filters", phase_filters),
                   ("d strict", phase_strict), ("e session", phase_session)]
    device = None
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            result = fn()
        except Exception as e:  # every failure ends the run
            if not isinstance(e, PhaseFailed):
                traceback.print_exc()
            print(f"phase {name}: FAILED after "
                  f"{time.perf_counter() - t0:.1f} s: {e}", flush=True)
            return 1
        if device is None:
            device = result
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
