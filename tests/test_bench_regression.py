"""bench.py's orchestration and its correctness lanes at CPU scale: the
deadline scheduler always lands the one-line JSON artifact, and the
differential harnesses hold their bounds against the oracle."""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402


def test_deadline_skip_prints_and_main_always_emits_json(monkeypatch,
                                                         capsys):
    # _skip: an exhausted deadline refuses the lane with the mandatory
    # SKIPPED(budget) line.
    monkeypatch.setattr(bench, "DEADLINE_SECS", 10.0)
    monkeypatch.setattr(bench, "_T0", __import__("time").monotonic() - 9.0)
    assert bench._skip("pump gate", floor=60.0)
    assert "# pump gate SKIPPED(budget):" in capsys.readouterr().err
    # A healthy deadline does not skip.
    monkeypatch.setattr(bench, "_T0", __import__("time").monotonic())
    monkeypatch.setattr(bench, "DEADLINE_SECS", 1500.0)
    assert not bench._skip("pump gate", floor=60.0)
    # main() must emit the one-line JSON artifact even when the lane
    # runner dies outright (the r04 failure mode was a kill with no
    # JSON; now any partial state flushes).
    monkeypatch.setattr(bench, "_run_lanes",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("x")))
    rc = bench.main()
    out = capsys.readouterr()
    line = [l for l in out.out.splitlines() if l.startswith("{")]
    assert line, out.out
    parsed = json.loads(line[-1])
    assert parsed["metric"] == "tracker_bench_x_realtime_48k"
    assert rc == 1  # no lane landed -> honest zero-value artifact


def test_gate_floors_reserve_budget_against_earlier_lanes(monkeypatch,
                                                          capsys):
    # r05's first full run: poly_16 cold-compiled for 780 s and starved
    # every downstream gate.  The floors make that impossible: with 900 s
    # left, a headline workload (before all gates) may spend only
    # 900 - reserve - sum(floors) and must SKIP below 60 s affordable,
    # while the LAST gate (soak) still sees nearly the whole remainder.
    import time as _time
    monkeypatch.setattr(bench, "DEADLINE_SECS", 900.0)
    monkeypatch.setattr(bench, "_T0", _time.monotonic())
    total_floors = sum(f for _, f in bench.GATE_FLOORS)
    assert total_floors == 760
    aff_workload = bench._afford(None)
    assert aff_workload < 900 - total_floors  # reserve also held back
    assert bench._afford("soak") > 850
    # streaming's affordance excludes every floor after it, not its own.
    assert abs(bench._afford("streaming") -
               (bench._afford("soak") - (total_floors - 120))) < 1.0
    # With only the floors left, a workload skips but the gates run.
    monkeypatch.setattr(bench, "_T0",
                        _time.monotonic() - (900 - total_floors - 20))
    assert bench._skip("marks_4_40", 60, after=None)
    assert "# marks_4_40 SKIPPED(budget)" in capsys.readouterr().err
    assert not bench._skip("fuzz_device gate", 100, after="fuzz_device")
    assert not bench._skip("soak gate", 150, after="soak")


def test_main_flushes_partial_results_on_interrupt(monkeypatch, capsys):
    # A SIGTERM-style interrupt mid-run: whatever landed still produces
    # the regression table and the JSON line.
    def fake_lanes(results, extra_msps, failed_gates):
        results["filter_1_1"] = 1.0e9
        bench._STOPPING[0] = True

    monkeypatch.setattr(bench, "_run_lanes", fake_lanes)
    try:
        rc = bench.main()
    finally:
        bench._STOPPING[0] = False
    out = capsys.readouterr()
    assert "partial results flushed" in out.err
    parsed = json.loads(
        [l for l in out.out.splitlines() if l.startswith("{")][-1])
    assert parsed["value"] > 0
    assert rc in (0, 2)


def test_fuzz_device_lane_on_cpu(capsys):
    # The fuzz_device lane's harness, driven on the CPU backend with a small
    # case bank (4 structures x 2 const-jitter variants): the production
    # fast/jit render of every case must hold the differential suite's
    # statistical gates vs the oracle.
    ok, fail, skip, failures = bench.bench_fuzz_device(seed0=5000,
                                                    n_structs=4,
                                                    n_variants=2)
    assert fail == 0, failures
    assert ok >= 4  # the bank can't be all skips
    err = capsys.readouterr().err
    assert "# fuzz_device:" in err and "seeds 5000..5003" in err
    assert "2 const-jitter variants" in err


def test_fuzz_device_budget_stop_reports_and_counts(capsys):
    # A lane whose internal budget expires must stop issuing cases and
    # say so — never bust the subprocess cap.
    ok, fail, skip, _ = bench.bench_fuzz_device(seed0=5000, budget=0.0)
    assert ok + fail + skip == 0
    err = capsys.readouterr().err
    assert "budget-stopped at 5000/v0" in err


def test_jitter_consts_preserves_compiled_structure():
    # Variants must reuse the base structure's executable: identical
    # structure_key, identical tree shape, with Reset-trigger and
    # Fin-length consts frozen (they bake into the executable).
    import random

    from tuun_jax import fuzzgen, ir
    from tuun_jax.engine import structure_key

    for seed in range(5000, 5016):
        rng = random.Random(seed)
        w0 = fuzzgen.random_waveform(rng, depth=4 + seed % 2)
        wv = fuzzgen.jitter_consts(w0, random.Random(seed * 1000 + 1))
        assert structure_key(w0, 44100) == structure_key(wv, 44100), seed
        # At least one movable const actually moved for trees that
        # have any (zeros and frozen contexts legitimately pin some).
        consts0 = [x.value for x in w0.walk() if isinstance(x, ir.Const)]
        constsv = [x.value for x in wv.walk() if isinstance(x, ir.Const)]
        assert len(consts0) == len(constsv), seed


def test_fuzz_shapes_harness_on_cpu(capsys):
    # The production-shape differential tier, shrunk to CPU scale: the
    # four class programs render in exact_df at BOTH block shapes
    # (one full-piece dispatch + 1024-lane state-carried blocks) and
    # hold the strict per-class bounds vs the oracle.
    assert bench.bench_fuzz_shapes(n=1 << 13, sr=8000)
    err = capsys.readouterr().err
    assert "# fuzz_shapes: 8 ok / 0 fail" in err
    for cname in ("nco", "fm", "filter", "reset"):
        assert f"{cname}/offline" in err and f"{cname}/stream" in err


def test_longrender_harness_on_cpu(capsys):
    # The long-render product proof's machinery at CPU scale: the
    # 4-class score evaluates end to end (source -> evaluator ->
    # optimizer), renders in exact_df, and matches the native oracle at
    # the strict bound over its opening seconds.  (The full 64-s render
    # runs on the device: bench.py --one longrender.)
    assert bench.bench_longrender(n=2 * bench.SAMPLE_RATE)
    err = capsys.readouterr().err
    assert "# longrender: PASS" in err
