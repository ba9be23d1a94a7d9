"""Web runtime tests: the `<tuun-synth>` server (tools/web_demo.py).

Drives the HTTP surface the custom element speaks — install, chunked
float32 streaming, live slider ramps, keys notes, stop — against a real
TuunSession (exact precision, no jit), validating stream content
numerically against a direct session render.  The analogue of the
reference's wasm.rs tests (install/process web examples, wasm.rs:434-543).
"""

import http.client
import json
import math
import threading

import numpy as np
import pytest

from tuun_jax.session import TuunSession
from tuun_jax.tools.web_demo import WEB_ROOT, TuunWebServer

SR = 8000
BLOCK = 256


@pytest.fixture(scope="module")
def server():
    srv = TuunWebServer(("127.0.0.1", 0), sample_rate=SR, block_size=BLOCK,
                        precision="exact", jit=False)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()


def conn(server):
    return http.client.HTTPConnection("127.0.0.1", server.server_port,
                                      timeout=30)


def post(server, path, body):
    c = conn(server)
    c.request("POST", path, json.dumps(body),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    out = json.loads(r.read())
    c.close()
    return r.status, out


def read_stream(server, iid, n_samples):
    c = conn(server)
    c.request("GET", f"/api/stream?id={iid}")
    r = c.getresponse()
    data = b""
    while len(data) < 4 * n_samples:
        chunk = r.read(4 * BLOCK)
        if not chunk:
            break
        data += chunk
    c.close()
    return np.frombuffer(data[:4 * n_samples], dtype="<f4")


def test_static_pages(server):
    c = conn(server)
    c.request("GET", "/")
    r = c.getresponse()
    page = r.read().decode()
    assert r.status == 200 and "<tuun-synth" in page
    c.request("GET", "/tuun-synth.js")
    r = c.getresponse()
    js = r.read().decode()
    assert r.status == 200 and "registerProcessor" in js
    c.close()
    # the served assets are the repo's web/ files
    assert (WEB_ROOT / "index.html").exists()


def test_install_and_stream_matches_direct_session(server):
    status, out = post(server, "/api/install",
                       {"id": "t1", "expression": "$440 | fin(time - 0.5)"})
    assert status == 200
    assert out == {"kind": "waveform", "sliders": [], "sample_rate": SR}
    got = read_stream(server, "t1", SR // 2)
    assert len(got) == SR // 2
    expected = np.sin(math.tau * 440 * np.arange(SR // 2) / SR)
    np.testing.assert_allclose(got, expected, atol=1e-4)


def test_stream_ends_when_the_piece_finishes(server):
    post(server, "/api/install",
         {"id": "t2", "expression": "1 | fin(time - 0.1)"})
    c = conn(server)
    c.request("GET", "/api/stream?id=t2")
    r = c.getresponse()
    data = r.read()  # must terminate on its own
    c.close()
    samples = np.frombuffer(data, dtype="<f4")
    assert np.count_nonzero(samples) == int(0.1 * SR)


def test_slider_install_reports_values_and_updates_ramp(server):
    status, out = post(server, "/api/install", {
        "id": "t3",
        "expression": "gain | fin(time - 10)",
        "sliders": '["gain:0.25:0:1"]'})
    assert status == 200 and out["kind"] == "waveform"
    assert out["sliders"] == [
        {"label": "gain", "normalized": 0.25, "value": 0.25}]
    # One continuous stream across the slider change: blocks before the
    # change hold 0.25, the splice is a one-block monotonic ramp, then
    # steady 1.0 (the server renders ahead, so the ramp's block position
    # is nondeterministic — but the sequence shape is exact).
    c = conn(server)
    c.request("GET", "/api/stream?id=t3")
    r = c.getresponse()
    first = np.frombuffer(r.read(4 * BLOCK), dtype="<f4")
    np.testing.assert_allclose(first, 0.25, atol=1e-6)
    status, out = post(server, "/api/slider",
                       {"id": "t3", "label": "gain", "normalized": 1.0})
    assert status == 200 and out["value"] == pytest.approx(1.0)
    chunks = [first]
    for _ in range(50):
        chunk = np.frombuffer(r.read(4 * BLOCK), dtype="<f4")
        chunks.append(chunk)
        if len(chunk) and chunk[-1] == pytest.approx(1.0, abs=1e-6):
            break
    c.close()
    got = np.concatenate(chunks)
    assert got[-1] == pytest.approx(1.0, abs=1e-6)
    assert np.all(got >= 0.25 - 1e-6) and np.all(got <= 1.0 + 1e-6)
    assert np.all(np.diff(got) >= -1e-6)  # click-free: monotonic ramp up


def test_keys_install_note_on_off(server):
    status, out = post(server, "/api/install", {
        "id": "t4",
        "expression": "fn(k, v) => ($(110 * v) | fin(time - 5),"
                      " 0 | fin(time - 0))"})
    assert status == 200 and out["kind"] == "keys"
    status, _ = post(server, "/api/note_on",
                     {"id": "t4", "key": 60, "velocity": 127})
    assert status == 200
    got = read_stream(server, "t4", BLOCK)
    expected = np.sin(math.tau * 110 * np.arange(BLOCK) / SR)
    np.testing.assert_allclose(got, expected, atol=1e-4)
    status, _ = post(server, "/api/note_off", {"id": "t4", "key": 60})
    assert status == 200


def test_stop_supersedes_stream(server):
    post(server, "/api/install", {"id": "t5", "expression": "$220"})
    got = read_stream(server, "t5", BLOCK)
    assert np.abs(got).max() > 0.5
    status, out = post(server, "/api/stop", {"id": "t5"})
    assert status == 200 and out == {"ok": True}
    # a fresh stream for the stopped instance terminates immediately
    c = conn(server)
    c.request("GET", "/api/stream?id=t5")
    r = c.getresponse()
    assert len(r.read()) == 0
    c.close()


def test_install_error_is_reported(server):
    status, out = post(server, "/api/install",
                       {"id": "t6", "expression": "1 +"})
    assert status == 400 and "error" in out


def test_matches_reference_web_example(server):
    """The reference index.html's lpf example installs and streams
    (web/index.html in both repos)."""
    status, out = post(server, "/api/install", {
        "id": "t7",
        "expression": "square(220) | lpf(Q, cutoff)",
        "sliders": '["Q:0.707:0.1:1",'
                   '"cutoff:0.5886:fn(x) => 200 * pow(50, x)"]',
        "opens": ["std"]})
    assert status == 200 and out["kind"] == "waveform"
    labels = [s["label"] for s in out["sliders"]]
    assert labels == ["Q", "cutoff"]
    assert out["sliders"][1]["value"] == pytest.approx(
        200 * 50 ** 0.5886, rel=1e-3)
    got = read_stream(server, "t7", 2 * BLOCK)
    session = TuunSession(sample_rate=SR, block_size=BLOCK,
                          precision="exact", jit=False)
    session.install("square(220) | lpf(Q, cutoff)",
                    sliders='["Q:0.707:0.1:1",'
                            '"cutoff:0.5886:fn(x) => 200 * pow(50, x)"]')
    ref = np.concatenate([session.process(), session.process()])
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_unknown_id_is_404_and_creates_no_session(server):
    before = set(server.instances)
    status, out = post(server, "/api/slider",
                       {"id": "ghost", "label": "x", "normalized": 0.5})
    assert status == 404
    c = conn(server)
    c.request("GET", "/api/stream?id=ghost2")
    r = c.getresponse()
    assert r.status == 404
    r.read()
    c.close()
    assert set(server.instances) == before  # no sessions leaked


def test_keys_stream_carries_silence_between_notes(server):
    """A keys instrument idles between notes; its stream must survive
    the gaps (carrying silence) so a note_on never races a stream
    restart."""
    status, out = post(server, "/api/install", {
        "id": "t8",
        "expression": "fn(k, v) => ($(220) * v | fin(time - 5),"
                      " 0 | fin(time - 0))"})
    assert status == 200 and out["kind"] == "keys"
    c = conn(server)
    c.request("GET", f"/api/stream?id=t8")
    r = c.getresponse()
    quiet = np.frombuffer(r.read(4 * BLOCK), dtype="<f4")
    assert len(quiet) == BLOCK and np.all(quiet == 0.0)  # silence, not EOF
    post(server, "/api/note_on", {"id": "t8", "key": 60, "velocity": 127})
    # the same stream starts carrying the note within a few blocks
    for _ in range(20):
        got = np.frombuffer(r.read(4 * BLOCK), dtype="<f4")
        if np.abs(got).max() > 0.1:
            break
    else:
        raise AssertionError("note never reached the stream")
    post(server, "/api/note_off", {"id": "t8", "key": 60})
    c.close()


def test_instance_cap_evicts_oldest(server):
    from tuun_jax.tools import web_demo
    old_cap = web_demo.MAX_INSTANCES
    web_demo.MAX_INSTANCES = 4
    try:
        for i in range(6):
            post(server, "/api/install",
                 {"id": f"cap{i}", "expression": "$100 | fin(time - 9)"})
        assert len(server.instances) <= 4
        assert "cap0" not in server.instances
        # evicted instances' streams end immediately (generation bumped)
        c = conn(server)
        c.request("GET", "/api/stream?id=cap5")
        r = c.getresponse()
        assert len(r.read(4 * BLOCK)) == 4 * BLOCK  # survivor still live
        c.close()
    finally:
        web_demo.MAX_INSTANCES = old_cap


def test_concurrent_streams_stay_isolated(server):
    """Three elements streaming simultaneously (the demo page's normal
    state): each stream must carry its own session's audio — per-instance
    locks serialize process() but sessions must not cross-talk."""
    freqs = {"c1": 200, "c2": 300, "c3": 400}
    for iid, f in freqs.items():
        post(server, "/api/install",
             {"id": iid, "expression": f"${f} | fin(time - 4)"})
    results = {}
    errors = []

    def reader(iid):
        try:
            results[iid] = read_stream(server, iid, SR // 4)
        except Exception as exc:  # pragma: no cover
            errors.append((iid, exc))

    threads = [threading.Thread(target=reader, args=(iid,))
               for iid in freqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    for iid, f in freqs.items():
        got = results[iid]
        expected = np.sin(math.tau * f * np.arange(SR // 4) / SR)
        np.testing.assert_allclose(got, expected, atol=1e-4,
                                   err_msg=f"stream {iid} cross-talked")
