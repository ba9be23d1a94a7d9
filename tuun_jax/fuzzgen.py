"""Random-program generator for differential fuzzing.

The interval algebra has a large state space (finite/infinite operands,
merge extension, append switchover, fin cutoffs, filter delays, reset
edges, nested everything); random trees cover corners hand-written tests
don't.  Used by the CPU differential suites (tests/test_fuzz.py) and by
bench.py's fuzz_device lane, which renders the SAME seed-logged trees
through the production fast/jit path on the attached accelerator and
diffs them against the per-sample oracle — the correctness gate that
sees the device's own codegen (fusions, NCO lowering, analytic-Reset
tiers).
"""

from __future__ import annotations

import random

import numpy as np

from . import ir, oracle


def random_waveform(rng: random.Random, depth: int) -> ir.Waveform:
    leaves = ["const", "time", "fixed", "noise"]
    inner = ["binop", "fin", "append", "sine", "filter", "reset", "alt",
             "marked"]
    kind = rng.choice(leaves if depth <= 0 else leaves + inner * 3)
    if kind == "const":
        return ir.Const(round(rng.uniform(-3, 3), 2))
    if kind == "time":
        return ir.Time()
    if kind == "noise":
        return ir.Noise()
    if kind == "fixed":
        n = rng.randint(0, 6)
        return ir.Fixed([round(rng.uniform(-2, 2), 2) for _ in range(n)])
    sub = lambda: random_waveform(rng, depth - 1)  # noqa: E731
    if kind == "binop":
        op = rng.choice(list(ir.Operator))
        if op == ir.Operator.POWER:
            # keep pow well-defined: positive base
            return ir.BinaryPointOp(op,
                                    ir.Const(round(rng.uniform(0.2, 2), 2)),
                                    sub())
        return ir.BinaryPointOp(op, sub(), sub())
    if kind == "fin":
        if rng.random() < 0.7:
            length = ir.BinaryPointOp(
                ir.Operator.SUBTRACT, ir.Time(),
                ir.Const(round(rng.uniform(0, 4), 2)))
        else:
            length = sub()  # arbitrary length waveform: value path
        return ir.Fin(length, sub())
    if kind == "append":
        return ir.Append(sub(), sub())
    if kind == "sine":
        freq = rng.choice([
            ir.Const(round(rng.uniform(0, 8), 2)),
            ir.BinaryPointOp(ir.Operator.MULTIPLY, ir.Time(),
                             ir.Const(round(rng.uniform(0, 3), 2))),
            sub()])
        return ir.Sine(freq, sub())
    if kind == "filter":
        k = rng.randint(1, 3)
        j = rng.randint(0, 2)
        coeff = lambda: rng.choice([  # noqa: E731
            ir.Const(round(rng.uniform(-0.6, 0.6), 2)), sub()])
        return ir.Filter(sub(), [coeff() for _ in range(k)],
                         [coeff() for _ in range(j)])
    if kind == "reset":
        # Triggers spanning the analytic-Reset decision surface: plain
        # NCO sines (tier 0), weighted composites (hard-sync candidates),
        # biased / LFO-modulated sines (pulse-width paths), and arbitrary
        # subtrees (must fall back to the generic sampled-sign scan).
        base = lambda: ir.Sine(  # noqa: E731
            ir.Const(round(rng.uniform(0.5, 6), 2)),
            # Mostly zero phase: the analytic tiers require it (nonzero
            # phase gates to the generic scan — also worth covering).
            ir.Const(0.0 if rng.random() < 0.7
                     else round(rng.uniform(0.1, 6), 2)))
        r = rng.random()
        if r < 0.4:
            trig = base()
        elif r < 0.6:
            trig = ir.BinaryPointOp(
                ir.Operator.ADD, base(),
                ir.BinaryPointOp(ir.Operator.MULTIPLY, base(),
                                 ir.Const(round(rng.uniform(0.1, 0.9), 2))))
        elif r < 0.8:
            width = rng.choice([
                ir.Const(round(rng.uniform(-0.7, 0.7), 2)),
                ir.BinaryPointOp(  # slow LFO width: the PWM tier
                    ir.Operator.MULTIPLY,
                    ir.Sine(ir.Const(round(rng.uniform(0.05, 0.3), 2)),
                            ir.Const(0.0)),
                    ir.Const(round(rng.uniform(0.1, 0.5), 2)))])
            trig = ir.BinaryPointOp(ir.Operator.SUBTRACT, base(), width)
        else:
            trig = sub()
        return ir.Reset(trig, sub())
    if kind == "alt":
        return ir.Alt(sub(), sub(), sub())
    if kind == "marked":
        return ir.Marked(rng.randint(0, 5), sub())
    raise AssertionError(kind)


def ill_conditioned(w: ir.Waveform, n: int, sr: int, seed: int) -> bool:
    """Any subtree blowing past 1e5 amplifies f32 last-bit rounding
    chaotically (e.g. sin() of a 1e9-magnitude phase from an unstable
    feedback filter has zero significant bits); differential comparison
    of such trees is meaningless.

    Sine PHASE arguments get a much tighter bound (100 ≈ 32π): sin has
    unit sensitivity to its argument, so a phase computed two
    legitimate f32 ways (the oracle's sequential per-sample order vs
    an accelerator's fused/reassociated order) differs by
    ~|phase|·κ·eps, and with κ ~ 10²–10³ from a chaotic upstream (a
    noise-fed time-varying feedback filter, as in seed 5000) a
    270-magnitude phase already moves sin by ~2e-2.  Musical phases are
    radians-scale; huge raw phases only arise in fuzz artifacts."""
    phase_roots = set()
    for sub in w.walk():
        if isinstance(sub, ir.Sine):
            phase_roots.add(id(sub.phase))
    for sub in w.walk():
        try:
            v = oracle.render(sub, n, sr, seed=seed)
        except Exception:
            return True
        if len(v):
            mx = np.nanmax(np.abs(v))
            if mx > 1e5:
                return True
            if id(sub) in phase_roots and mx > 100.0:
                return True
    return False


def jitter_consts(w: ir.Waveform, rng: random.Random) -> ir.Waveform:
    """A const-perturbed variant with the SAME compiled structure.

    Every Const leaf scales by a factor in [0.75, 1.25] (zeros stay
    zero, signs preserved) — except inside Reset triggers and Fin
    lengths, whose concrete values bake into the executable (analytic
    edge algebra / host-fetched cutoff lits; engine.structure_key) and
    would force a fresh XLA compile.  Same tree shape + same frozen
    values -> identical HLO -> the engine and the persistent compile
    cache reuse the structure's executable, so a batch of variants
    costs one compile plus cheap dispatches (bench.py fuzz_device)."""
    def go(x: ir.Waveform, frozen: bool) -> ir.Waveform:
        if isinstance(x, ir.Const):
            if frozen or x.value == 0:
                return x
            return ir.Const(round(x.value * (0.75 + 0.5 * rng.random()), 4))
        if isinstance(x, ir.Reset):
            return ir.Reset(go(x.trigger, True), go(x.waveform, frozen))
        if isinstance(x, ir.Fin):
            return ir.Fin(go(x.length, True), go(x.waveform, frozen))
        kids = x.children()
        if not kids:
            return x
        return x.replace_children(tuple(go(c, frozen) for c in kids))
    return go(w, False)
