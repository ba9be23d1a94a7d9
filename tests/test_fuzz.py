"""Differential fuzzing: random IR trees, oracle vs engine, many block sizes.

The interval algebra has a large state space (finite/infinite operands,
merge extension, append switchover, fin cutoffs, filter delays, reset
edges, nested everything); random trees cover corners the hand-written
tests don't."""

import math
import os
import random

import numpy as np
import pytest

from tuun_jax import engine, ir, optimizer, oracle, parser
from tuun_jax.fuzzgen import random_waveform
from tuun_jax.fuzzgen import ill_conditioned as _ill_conditioned

SR = 4


def ill_conditioned(w, n, seed):
    return _ill_conditioned(w, n, SR, seed)

# Soak knob: TUUN_FUZZ_SCALE=10 multiplies every fuzz lane's seed count
# (seed ranges stay disjoint across lanes; CI default is 1).
FUZZ_SCALE = max(1, int(os.environ.get("TUUN_FUZZ_SCALE", "1")))


def seeds(start, stop, base=1000):
    """The lane's CI seeds plus FUZZ_SCALE-1 extra banks of the same
    width, offset by `base` per bank so lanes never collide."""
    width = stop - start
    out = list(range(start, stop))
    for bank in range(1, FUZZ_SCALE):
        out.extend(range(start + bank * base, start + bank * base + width))
    return out


@pytest.mark.parametrize("seed", seeds(0, 40))
def test_fuzz_engine_vs_oracle(seed):
    rng = random.Random(seed)
    w = random_waveform(rng, depth=3)
    n = 24
    ref = oracle.render(w, n, SR, seed=seed)
    if not np.all(np.isfinite(ref)):
        pytest.skip("unstable filter / inf samples")
    if ill_conditioned(w, n, seed):
        pytest.skip("ill-conditioned: internal magnitudes amplify rounding")
    # Noise streams are keyed by pre-order node position; the optimizer
    # reshapes the tree, so optimized-form comparison only holds for
    # noise-free graphs (matching the reference, whose noise is never
    # reproducible at all).
    has_noise = any(isinstance(x, ir.Noise) for x in w.walk())
    forms = (w,) if has_noise else (w, optimizer.optimize(w))
    for form in forms:
        for block in (3, 8, 32):
            # Compare against the oracle generating with the SAME block
            # segmentation: non-const filter coefficients are generated
            # into fresh zero buffers per generate() window (as in the
            # reference), so written-but-invalid coefficient samples — which
            # downstream taps legitimately read — depend on the blocking.
            ref_b = oracle.render(form, n, SR, seed=seed, block=block)
            got = engine.render(form, n, SR, precision="exact", seed=seed,
                                block=block, jit=False)
            assert len(got) == len(ref_b), (
                f"seed={seed} block={block} len {len(got)} != {len(ref_b)}\n{form}")
            np.testing.assert_allclose(
                got, ref_b, atol=2e-4, rtol=1e-3,
                err_msg=f"seed={seed} block={block}\n{form}")


@pytest.mark.parametrize("seed", seeds(40, 56))
def test_fuzz_native_vs_oracle(seed):
    from tuun_jax import native
    if not native.native_available():
        pytest.skip("no native toolchain")
    rng = random.Random(seed)
    w = random_waveform(rng, depth=4)
    n = 48
    # Block-matched comparison: written-but-invalid filter-coefficient
    # samples depend on the generate() window segmentation (fresh zero
    # buffers per window, as in the reference).
    ref = oracle.render(w, n, SR, seed=seed, block=7)
    got = native.render(w, n, SR, seed=seed, block=7)
    assert len(got) == len(ref), f"seed={seed}\n{w}"
    mask = np.isfinite(ref)
    np.testing.assert_allclose(got[mask], ref[mask], atol=1e-5, rtol=1e-4,
                               err_msg=f"seed={seed}\n{w}")


@pytest.mark.parametrize("seed", seeds(56, 72))
def test_fuzz_reloc_fast_path_vs_oracle(seed):
    """The opt-in relocatable fast path (reloc_fast=True) against the
    oracle, over random trees that happen to be relocatable."""
    from tuun_jax.engine.graph import CompiledVoice, EngineConfig
    rng = random.Random(seed)
    w = random_waveform(rng, depth=3)
    ref = oracle.render(w, 24, SR, seed=seed)
    if not np.all(np.isfinite(ref)):
        pytest.skip("unstable filter / inf samples")
    if ill_conditioned(w, 24, seed):
        pytest.skip("ill-conditioned")
    cfg = EngineConfig(SR, "exact", seed=seed, jit=False, reloc_fast=True)
    cv = CompiledVoice(w, cfg)
    if not cv.relocatable:
        pytest.skip("tree not relocatable")
    P = cv.params(seed)
    st = cv.init(P)
    out = []
    for _ in range(4):
        y, v, st, _ = cv.render_block(P, st, 8)
        out.append(np.asarray(y)[:int(v)])
        if int(v) < 8:
            break
    got = np.concatenate(out) if out else np.zeros(0, np.float32)
    ref_b = oracle.render(w, len(got), SR, seed=seed, block=8)
    n = min(len(got), len(ref_b))
    np.testing.assert_allclose(got[:n], ref_b[:n], atol=2e-4, rtol=1e-3,
                               err_msg=f"seed={seed}\n{w}")


@pytest.mark.parametrize("seed", seeds(72, 96))
def test_fuzz_fast_precision_vs_exact(seed):
    """The production (fast) precision path against exact mode on random
    trees. NCO trigger-sign quantization can shift reset edges by one
    sample and filters smear locally, so the comparison is statistical:
    median error tiny, large-error lanes rare, lengths equal."""
    rng = random.Random(seed)
    w = random_waveform(rng, depth=3)
    n = 48
    ref = oracle.render(w, n, SR, seed=seed)
    if not np.all(np.isfinite(ref)):
        pytest.skip("unstable filter / inf samples")
    if ill_conditioned(w, n, seed):
        pytest.skip("ill-conditioned")
    exact = engine.render(w, n, SR, precision="exact", seed=seed,
                          block=16, jit=False)
    fast = engine.render(w, n, SR, precision="fast", seed=seed,
                         block=16, jit=False)
    assert len(fast) == len(exact), f"seed={seed}\n{w}"
    if not len(fast):
        return
    err = np.abs(fast - exact)
    scale = max(1.0, float(np.abs(exact).max()))
    assert float(np.median(err)) < 1e-3 * scale, f"seed={seed}\n{w}"
    assert float(np.mean(err > 0.05 * scale)) < 0.1, (
        f"seed={seed} large-error fraction {np.mean(err > 0.05*scale):.2f}"
        f"\n{w}")


def random_source(rng: random.Random, depth: int) -> str:
    """Random grammatical Tuun source text spanning every precedence
    level, unary op, sugar form, and binding construct of the grammar
    (parser.rs precedence `\\` < `|` < relational < `+ - &` < `* / ~*`
    < application < unary; chord/sequence sugar; named args)."""
    atoms = ["1", "2.5", "0.25", "440", "x", "y", "foo", "bar2",
             "true", "false", '"s"']
    if depth <= 0:
        return rng.choice(atoms)
    sub = lambda: random_source(rng, depth - 1)
    k = rng.randrange(14)
    if k == 0:
        return f"({sub()})"
    if k == 1:
        return f"{sub()} {rng.choice(['+', '-', '*', '/', '~*', '&'])} " \
               f"{sub()}"
    if k == 2:
        return f"{sub()} " \
               f"{rng.choice(['==', '!=', '<=', '>=', '<', '>'])} {sub()}"
    if k == 3:
        return rng.choice(list("!@$%-?")) + \
            rng.choice(["5", "x", f"({sub()})"])
    if k == 4:
        return f"if {sub()} then {sub()} else {sub()}"
    if k == 5:
        return f"let v{depth} = {sub()} in {sub()}"
    if k == 6:
        params = ", ".join(f"p{i}" for i in range(rng.randint(1, 3)))
        return f"fn({params}) => {sub()}"
    if k == 7:
        args = ", ".join(sub() for _ in range(rng.randint(1, 3)))
        return f"f({args})"
    if k == 8:
        return f"f({sub()}, y = {sub()})"
    if k == 9:
        return "[" + ", ".join(sub()
                               for _ in range(rng.randint(0, 3))) + "]"
    if k == 10:
        return f"({sub()}, {sub()})"
    if k == 11:
        return f"{sub()} | {sub()}"
    if k == 12:
        return f"{sub()} \\ {sub()}"
    # Sequence sugar parenthesized: `<[a]> != b` is a genuine grammar
    # quirk SHARED with the reference (its relational parser eats the
    # closing `>` and a bare unary op parses as a variable, parser.rs
    # parse_identifier), so bare sequences only compose safely in
    # contexts like `| f` — which the corpus tests cover.
    return rng.choice([f"{{[{sub()}, {sub()}]}}",
                       f"(<[{sub()}, {sub()}]>)"])


@pytest.mark.parametrize("seed", seeds(96, 136))
def test_fuzz_parser_printer_round_trip(seed):
    """The printer must be a parser fixed point on arbitrary grammatical
    input: print(parse(s)) re-parses cleanly and reprints verbatim (the
    reference's assert_round_trip property, parser.rs:1156-1174, over a
    generated corpus instead of hand-picked strings)."""
    from tuun_jax.expr import format_expr

    rng = random.Random(seed)
    src = random_source(rng, depth=4)
    e1 = parser.parse_program(src)
    p1 = format_expr(e1)
    e2 = parser.parse_program(p1)  # must parse without errors
    p2 = format_expr(e2)
    assert p1 == p2, f"seed={seed}\nsrc={src!r}\np1={p1!r}\np2={p2!r}"


def test_tracker_schedule_fuzz_across_configs():
    """Random multi-voice schedules (structures, starts, finite/infinite
    mixes) rendered through every tracker configuration — per-block
    vs deferred-sync vs fused vs lookahead windows — must produce the
    same mix; exact-precision runs also check the native C++ tracker.
    This is the test shape that catches cross-config state bugs (e.g.
    the group-rebuild rewind)."""
    import random

    from tuun_jax.tracker import Tracker
    from tuun_jax.ids import WaveformId
    from tuun_jax.player import build_top_level_waveform

    rng = random.Random(99)
    sr = 100

    def fin_note(freq, dur):
        return ir.Fin(
            ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                             ir.Const(dur)),
            ir.Sine(ir.Const(freq), ir.Const(0.0)))

    def rand_voice():
        kind = rng.randrange(4)
        freq = rng.uniform(1.0, 9.0)
        if kind == 0:
            return fin_note(freq, rng.uniform(0.2, 1.5))
        if kind == 1:  # infinite sine (same structure as others of kind 1)
            return ir.Sine(ir.Const(freq), ir.Const(0.0))
        if kind == 2:  # scaled constant segment
            return ir.Fin(
                ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                 ir.Const(rng.uniform(0.1, 1.0))),
                ir.Const(rng.uniform(0.1, 0.9)))
        return ir.BinaryPointOp(  # product structure
            ir.Operator.MULTIPLY, ir.Sine(ir.Const(freq), ir.Const(0.0)),
            ir.Const(rng.uniform(0.2, 0.8)))

    for trial in range(4):
        voices = [(rand_voice(), rng.randrange(0, 120))
                  for _ in range(rng.randint(2, 6))]
        block = rng.choice([8, 16, 32])
        n_blocks = 240 // block + 4
        outs = {}
        for label, kw, fuse, la in (
                ("plain", dict(sync_interval=1), False, 1),
                ("defer", dict(sync_interval=4), False, 1),
                ("fused", dict(sync_interval=4), True, 1),
                ("window", dict(sync_interval=4), True, 4)):
            t = Tracker(sr, block, precision="fast", jit=True, **kw)
            t.fuse = fuse
            t.fuse_blocking = True
            t.lookahead = la
            for i, (w, start) in enumerate(voices):
                t.play(WaveformId.program(i),
                       build_top_level_waveform(w, 0.0), start=start)
            outs[label] = np.concatenate(
                [np.asarray(t.render_block()[0]) for _ in range(n_blocks)])
        base = outs.pop("plain")
        for label, got in outs.items():
            np.testing.assert_allclose(
                got, base, atol=1e-5,
                err_msg=f"trial {trial} config {label}")
        # Exact-precision differential against the native C++ tracker.
        from tuun_jax import native
        if native.native_available():
            t = Tracker(sr, block, precision="exact", jit=False)
            nt = native.NativeTracker(sr)
            for i, (w, start) in enumerate(voices):
                t.play(WaveformId.program(i), w, start=start)
                nt.play(w, start=start, seed=0)
            ref = np.concatenate(
                [np.asarray(t.render_block()[0]) for _ in range(n_blocks)])
            got, _ = nt.render(len(ref))
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4,
                                       err_msg=f"trial {trial} native")


def test_tracker_command_fuzz_across_configs():
    """Random schedules with random MID-STREAM commands (Modify on a
    marked subtree — including analytic-Reset voices, whose sign/age
    state must carry exactly) must render the same mix through every
    tracker configuration.  Commands land at identical block boundaries
    in each config; windowed configs must interrupt and replay
    correctly."""
    import random

    from tuun_jax.ids import WaveformId
    from tuun_jax.player import build_top_level_waveform
    from tuun_jax.tracker import Tracker

    rng = random.Random(7)
    sr = 100

    def rand_voice():
        kind = rng.randrange(3)
        freq = rng.uniform(1.0, 9.0)
        amp = ir.Marked("amp", ir.Const(rng.uniform(0.3, 1.0)))
        if kind == 0:  # marked sine
            core = ir.Sine(ir.Const(freq), ir.Const(0.0))
        elif kind == 1:  # analytic reset (sawtooth-like): sign/age carry
            core = ir.Reset(ir.Sine(ir.Const(freq * math.tau / 6),
                                    ir.Const(0.0)), ir.Time())
        else:  # finite marked segment
            core = ir.Fin(
                ir.BinaryPointOp(ir.Operator.SUBTRACT, ir.Time(),
                                 ir.Const(rng.uniform(0.8, 2.0))),
                ir.Sine(ir.Const(freq), ir.Const(0.0)))
        return ir.BinaryPointOp(ir.Operator.MULTIPLY, core, amp)

    for trial in range(3):
        voices = [(rand_voice(), rng.randrange(0, 60))
                  for _ in range(rng.randint(2, 5))]
        block = rng.choice([8, 16])
        n_blocks = 240 // block
        # Command script: (block index, voice index, new amp value).
        commands = sorted(
            (rng.randrange(2, n_blocks - 1), rng.randrange(len(voices)),
             round(rng.uniform(0.1, 1.2), 3))
            for _ in range(rng.randint(1, 4)))
        outs = {}
        for label, kw, fuse, la in (
                ("plain", dict(sync_interval=1), False, 1),
                ("defer", dict(sync_interval=4), False, 1),
                ("fused", dict(sync_interval=4), True, 1),
                ("window", dict(sync_interval=4), True, 4)):
            t = Tracker(sr, block, precision="fast", jit=True, **kw)
            t.fuse = fuse
            t.fuse_blocking = True
            t.lookahead = la
            for i, (w, start) in enumerate(voices):
                t.play(WaveformId.program(i),
                       build_top_level_waveform(w, 0.0), start=start)
            chunks = []
            ci = 0
            for b in range(n_blocks):
                while ci < len(commands) and commands[ci][0] == b:
                    _, vi, val = commands[ci]
                    t.modify(WaveformId.program(vi), "amp", ir.Const(val))
                    ci += 1
                chunks.append(np.asarray(t.render_block()[0]))
            outs[label] = np.concatenate(chunks)
        base = outs.pop("plain")
        for label, got in outs.items():
            np.testing.assert_allclose(
                got, base, atol=1e-5,
                err_msg=f"trial {trial} config {label} "
                        f"commands {commands}")


@pytest.mark.parametrize("seed", seeds(136, 168))
def test_fuzz_exact_df_vs_oracle(seed):
    """exact_df — double-single (two-float) phase accumulation, no x64
    required (engine/df32.py, design.md §3b) — against the oracle at the
    STRICT exact tolerances.  This is the precision that lets the
    differential suite run in f32 arithmetic; here it is pinned on CPU
    over its own seed bank (the device run is bench.py's fuzz_device
    lane and chip_smoke.py phase d)."""
    rng = random.Random(seed)
    w = random_waveform(rng, depth=3)
    n = 24
    try:
        ref = oracle.render(w, n, SR, seed=seed)
    except AssertionError:
        # Reference-undefined: a Fin whose length waveform can cross
        # >= 0 in one window and not the next (e.g. a Noise cutoff) may
        # produce MORE samples after a short window; a Filter around it
        # then violates the exhausted-inner invariant the reference
        # asserts (generator.rs:414 panics on the same program — the
        # filter's K-1 bootstrap window alone can trigger it).
        pytest.skip("reference-undefined: non-monotone Fin length "
                    "under windowed rendering")
    if not np.all(np.isfinite(ref)):
        pytest.skip("unstable filter / inf samples")
    if ill_conditioned(w, n, seed):
        pytest.skip("ill-conditioned: internal magnitudes amplify rounding")
    has_noise = any(isinstance(x, ir.Noise) for x in w.walk())
    forms = (w,) if has_noise else (w, optimizer.optimize(w))
    for form in forms:
        for block in (3, 8, 32):
            try:
                ref_b = oracle.render(form, n, SR, seed=seed, block=block)
            except AssertionError:
                pytest.skip("reference-undefined: non-monotone Fin "
                            "length under blockwise rendering")
            got = engine.render(form, n, SR, precision="exact_df",
                                seed=seed, block=block, jit=False)
            assert len(got) == len(ref_b), (
                f"seed={seed} block={block} "
                f"len {len(got)} != {len(ref_b)}\n{form}")
            np.testing.assert_allclose(
                got, ref_b, atol=2e-4, rtol=1e-3,
                err_msg=f"seed={seed} block={block}\n{form}")
