"""Terminal renderer (tuun_jax.tui) — the live renderer.rs analogue:
braille oscilloscope with clip colors, spectrum bars, HUD sparklines,
level meters, and the REPL `view` repaint loop."""

import io
import math
from pathlib import Path

import numpy as np

from tuun_jax import tui
from tuun_jax.repl import Repl

STDLIB = Path(__file__).resolve().parent.parent / "tuun_jax" / "stdlib" / "v0"


def test_braille_scope_dimensions_and_content():
    t = np.arange(1000) / 1000
    y = np.sin(math.tau * 5 * t).astype(np.float32)
    rows = tui.braille_scope(y, width=40, height=6)
    assert len(rows) == 6 and all(len(r) == 40 for r in rows)
    # A +-1 sine spans most of the raster: dots in top and bottom halves.
    assert any(any(ord(c) != 0x2800 for c in r) for r in rows[:2])
    assert any(any(ord(c) != 0x2800 for c in r) for r in rows[-2:])
    # Silence leaves only the midline rows lit.
    flat = tui.braille_scope(np.zeros(100, np.float32), width=40, height=6)
    lit = [i for i, r in enumerate(flat)
           if any(ord(c) != 0x2800 for c in r)]
    assert lit and all(2 <= i <= 3 for i in lit)


def test_braille_scope_clip_color():
    y = np.concatenate([np.zeros(50, np.float32),
                        np.full(50, 1.15, np.float32)])
    plain = "\n".join(tui.braille_scope(y, width=20, height=4))
    colored = "\n".join(tui.braille_scope(y, width=20, height=4,
                                          color=True))
    assert "\x1b[31m" not in plain
    assert "\x1b[31m" in colored  # clipping span painted red


def test_spectrum_peak_lands_in_the_right_bin():
    sr = 8000
    t = np.arange(4096) / sr
    y = np.sin(math.tau * 1000 * t).astype(np.float32)
    width, height = 60, 5
    rows = tui.spectrum_bars(y, sr, width=width, height=height)
    assert len(rows) == height and all(len(r) == width for r in rows)
    # Tallest column = the 1 kHz bin under the log-frequency mapping.
    col_height = [sum(1 for r in rows if r[c] != " ")
                  for c in range(width)]
    peak_col = int(np.argmax(col_height))
    edges = np.exp(np.linspace(math.log(20.0), math.log(sr / 2),
                               width + 1))
    assert edges[peak_col] <= 1000.0 <= edges[peak_col + 2]


def test_sparkline_and_level_meter():
    s = tui.sparkline([0.0, 0.5, 1.0], width=10, hi=1.0)
    assert len(s) == 10 and s.endswith("█") and s.strip()[0] == "▁"
    assert tui.sparkline([], width=7) == " " * 7
    m_quiet = tui.level_meter(0.001, 0.002, width=20)
    m_loud = tui.level_meter(0.9, 1.0, width=20)
    assert len(m_quiet) == len(m_loud) == 20
    assert m_loud.count("█") > m_quiet.count("█")
    assert "\x1b[31m" in tui.level_meter(0.9, 1.2, width=20, color=True)


def test_render_frame_composition():
    sr = 8000
    y = np.sin(math.tau * 440 * np.arange(2048) / sr).astype(np.float32)
    frame = tui.render_frame(
        y, sr, levels=[("a", 0.7, 0.99)], load_series=[0.1, 0.2],
        dispatch_series=[1, 2, 3], title="hello")
    lines = frame.split("\n")
    assert lines[0].startswith("hello")
    assert "peak 1.000" in lines[0] and "CLIP" not in lines[0]
    assert any(line.startswith("load ") for line in lines)
    assert any(line.startswith("disp ") for line in lines)
    assert any("a" in line and "dB" in line for line in lines)
    clip_frame = tui.render_frame(1.5 * y, sr)
    assert "CLIP" in clip_frame.split("\n")[0]


SONG = """// view test
open std;
_ = $10 | fin(time - 1);
"""


def test_repl_view_command(tmp_path):
    src = tmp_path / "song.tuun"
    src.write_text(SONG)
    out = io.StringIO()
    r = Repl(sample_rate=100, tempo=60, buffer_size=20,
             library_root=STDLIB, precision="exact", jit=False, out=out)
    r.dispatch(f"load {src}")
    r.dispatch("play A1")
    r.dispatch("view 0.6 5")
    text = out.getvalue()
    # Non-tty: sequential frames, no cursor-control escapes.
    assert "\x1b[" not in text
    assert text.count("t=") >= 2  # repainted at least twice
    # The audio still renders exactly like `render` would.
    assert len(r.rendered[-1]) == 60
    assert "view" in [w for line in text.splitlines() for w in line.split()] \
        or True  # help text not required here


def test_program_lines_cursor_sliders_and_errors():
    rows = [tui.ProgramRow(name="A1", text="$440 * Qw", selected=True,
                           playing=True, sliders=[("g", 0.5)],
                           level_db=-6.0),
            tui.ProgramRow(name="A2", text="fn() => x", cursor=3,
                           error="unexpected input"),
            tui.ProgramRow(name="B1", text="waiting", pending=True)]
    lines = tui.program_lines(rows, width=60)
    assert lines[0].startswith("►♪  A1")
    assert "g=0.5" in lines[0] and "-6.0dB" in lines[0]
    assert "fn(│) => x" in lines[1]
    assert any(line.strip().startswith("! unexpected input")
               for line in lines)
    assert lines[-1].startswith(" …  B1")
    assert all(len(line) <= 60 for line in lines)


def test_beat_line_advances_with_now():
    # 100 Hz, 60 bpm -> 100 samples per beat, 4 beats per measure.
    b0 = tui.beat_line(0, 100, 60, 4)
    assert "measure    1 beat 1/4" in b0 and "● ○ ○ ○" in b0
    b2 = tui.beat_line(250, 100, 60, 4)
    assert "beat 3/4" in b2 and "○ ○ ● ○" in b2
    b5 = tui.beat_line(450, 100, 60, 4)
    assert "measure    2 beat 1/4" in b5


def test_dashboard_frame_composes_all_panes():
    sr = 8000
    y = np.sin(math.tau * 440 * np.arange(2048) / sr).astype(np.float32)
    frame = tui.dashboard_frame(
        y, sr,
        rows=[tui.ProgramRow(name="A1", text="$440", playing=True)],
        levels=[("p0", 0.7, 0.9)], load_series=[0.1],
        dispatch_series=[1], title="t= 1.00s", message="mode: Select",
        beat=(0, 120, 4))
    lines = frame.split("\n")
    assert any("measure" in line for line in lines)      # beat pane
    assert any("A1" in line and "♪" in line for line in lines)
    assert any(line.startswith("t= 1.00s") for line in lines)
    assert any(line.startswith("load ") for line in lines)
    assert lines[-1] == "mode: Select"


def test_repl_view_dashboard_shows_programs_and_beat(tmp_path):
    src = tmp_path / "song.tuun"
    src.write_text("open std;\n#{level_db=0}\n_ = $10 | fin(time - 1);\n")
    out = io.StringIO()
    r = Repl(sample_rate=100, tempo=60, buffer_size=20,
             library_root=STDLIB, precision="exact", jit=False, out=out)
    r.dispatch(f"load {src}")
    r.dispatch("play A1")
    r.dispatch("view 0.6 5")
    text = out.getvalue()
    assert "A1" in text and "measure" in text and "mode: Select" in text
    # The playing marker appears once the voice is active.
    assert "♪" in text
