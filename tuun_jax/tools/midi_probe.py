"""Launchkey protocol scratchpad + device simulator.

The counterpart of /root/reference/src/misc/midi_test.rs — an
interactive protocol probe for the Launchkey MK4.  The reference pokes
feature-control CCs at real hardware and watches what comes back; with
no controller attached, this module carries a *simulated*
device (`FakeLaunchkey`) that implements the documented protocol
surface the driver speaks (DAW-mode handshake, feature CCs, pad RGB
SysEx, display strips), plus gesture helpers that emit the byte
sequences a user action produces on the DAW/MIDI ports.

Run ``python -m tuun_jax.tools.midi_probe`` for a scripted protocol
trace: it connects a driver to the fake device, replays a session
(mode switches, encoder turns, pad presses, LED pushes) and prints
every byte exchanged in both directions.  The simulator doubles as the
conformance harness for tests/test_launchkey.py.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import launchkey as lk


@dataclass
class FakeLaunchkey:
    """Simulates the controller end of the protocol.

    `receive(message)` consumes bytes the driver sent to the DAW-In
    port and updates device state; gesture methods return the bytes the
    device would emit on its DAW-Out / MIDI-Out ports for user actions
    (feed them to `Launchkey.feed_daw` / `feed_midi`)."""

    daw_mode: bool = False
    encoder_relative: bool = False
    # User-visible mode state (what the *device* believes).
    encoder_mode: str = lk.PLUGIN
    pad_mode: str = lk.PAD_MODE_DAW
    # pad note id -> (r, g, b)
    pad_colors: Dict[int, Tuple[int, int, int]] = field(default_factory=dict)
    function_color: Optional[int] = None
    # display target -> {"arrangement": int, fields: {index: text}}
    displays: Dict[int, dict] = field(default_factory=dict)
    log: List[str] = field(default_factory=list)

    # -- driver -> device ---------------------------------------------------

    def receive(self, message: bytes) -> None:
        m = bytes(message)
        if m == bytes([0x9F, 0x0C, 0x7F]):
            self.daw_mode = True
            # Entering DAW mode resets pads to the DAW layout
            # (launchkey.rs:237-239).
            self.pad_mode = lk.PAD_MODE_DAW
            self.log.append("<- enter DAW mode")
            return
        if m == bytes([0x9F, 0x0C, 0x00]):
            self.daw_mode = False
            self.log.append("<- exit DAW mode")
            return
        if (len(m) == 3 and m[0] == 0xB0 | lk.FEATURE_CONTROL_CHANNEL
                and m[1] == lk.FEATURE_DAW_ENCODER_RELATIVE):
            self.encoder_relative = m[2] >= 64
            self.log.append(f"<- encoder relative output "
                            f"{'on' if self.encoder_relative else 'off'}")
            return
        if len(m) == 3 and m[0] == 0xB0 and m[1] == lk.PAD_FUNCTION_OFFSET:
            self.function_color = m[2]
            self.log.append(f"<- pad-function color {m[2]}")
            return
        if m[:1] == b"\xf0" and m[-1:] == b"\xf7":
            self._receive_sysex(m[1:-1])
            return
        self.log.append(f"<- unhandled {m.hex(' ')}")

    def _receive_sysex(self, payload: bytes) -> None:
        prefix = bytes(lk.STANDARD_SKU_PREFIX)
        if not payload.startswith(prefix):
            self.log.append(f"<- unknown sysex {payload.hex(' ')}")
            return
        body = payload[len(prefix):]
        if body[:2] == bytes(lk.PAD_RGB_COLOR) and len(body) == 6:
            pad, r, g, b = body[2], body[3], body[4], body[5]
            self.pad_colors[pad] = (r, g, b)
            self.log.append(f"<- pad {pad} color ({r},{g},{b})")
            return
        if body[:1] == bytes(lk.CONFIGURE_DISPLAY) and len(body) == 3:
            target, arrangement = body[1], body[2]
            d = self.displays.setdefault(target,
                                         {"arrangement": 0, "fields": {}})
            if arrangement & 0x1F == lk.DISPLAY_TRIGGER:
                self.log.append(f"<- display {target} redraw")
            else:
                d["arrangement"] = arrangement
                self.log.append(f"<- display {target} "
                                f"arrangement {arrangement}")
            return
        if body[:1] == bytes(lk.SET_DISPLAY_TEXT_FIELD) and len(body) >= 3:
            target, index = body[1], body[2]
            text = body[3:].decode("ascii", "replace")
            d = self.displays.setdefault(target,
                                         {"arrangement": 0, "fields": {}})
            d["fields"][index] = text
            self.log.append(f'<- display {target} field {index} = "{text}"')
            return
        self.log.append(f"<- unknown sysex body {body.hex(' ')}")

    # -- device -> host gestures ---------------------------------------------

    def turn_encoder(self, index: int, delta: int) -> bytes:
        """Relative encoder detents on the DAW port: CC 85+i on channel
        16 carrying 64+delta (launchkey.rs:462-481)."""
        assert self.encoder_relative, "driver must enable relative output"
        return bytes([0xB0 | lk.ENCODER_CHANNEL,
                      lk.ENCODER_RELATIVE_CC_OFFSET + index,
                      (lk.ENCODER_RELATIVE_PIVOT + delta) & 0x7F])

    def switch_encoder_mode(self, mode: str) -> bytes:
        """The encoder-mode button: CC 30 on channel 7, value 1=Mixer
        2=Plugin — and the device drops the relative-output feature on a
        mode CHANGE, which the driver must re-assert
        (launchkey.rs:264-271).  Selecting the already-active mode emits
        no CC and resets nothing (the runner's same-mode no-op,
        effects.rs:295-297, depends on this hardware behavior)."""
        if mode == self.encoder_mode:
            return b""
        self.encoder_mode = mode
        self.encoder_relative = False
        value = 1 if mode == lk.MIXER else 2
        return bytes([0xB0 | lk.ENCODER_MODE_CHANNEL, lk.ENCODER_MODE_CC,
                      value])

    def switch_pad_mode(self, mode: str) -> bytes:
        """Pad-layout select: CC 0x1D on channel 7; value 2 is the DAW
        layout (launchkey.rs:439-450)."""
        self.pad_mode = mode
        value = lk.PAD_MODE_DAW_VALUE if mode == lk.PAD_MODE_DAW else 0
        return bytes([0xB0 | lk.ENCODER_MODE_CHANNEL, lk.PAD_MODE_CC, value])

    def press_top_pad(self, index: int) -> bytes:
        return bytes([0x90, lk.DAW_PAD_TOP_ROW_OFFSET + index, 0x7F])

    def press_bottom_pad(self, index: int) -> bytes:
        return bytes([0x90, lk.DAW_PAD_BOTTOM_ROW_OFFSET + index, 0x7F])

    def press_function_pad(self) -> bytes:
        return bytes([0xB0, lk.PAD_FUNCTION_OFFSET, 0x7F])

    def press_nav(self, which: str) -> bytes:
        cc = {"next": 102, "prev": 103, "next_bank": 108,
              "prev_bank": 109}[which]
        return bytes([0xB0, cc, 0x7F])

    def play_key(self, key: int, velocity: int) -> bytes:
        """Keybed notes arrive on the MIDI port; release is a velocity-0
        note-on (launchkey.rs:560-575)."""
        return bytes([0x90, key, velocity & 0x7F])


def main() -> int:
    device = FakeLaunchkey()
    driver = lk.Launchkey(device.receive)

    def gesture(label: str, port: str, data: bytes) -> None:
        event = (driver.feed_daw(data) if port == "daw"
                 else driver.feed_midi(data))
        print(f"-> [{port}] {data.hex(' ')}  {label}: {event}")

    print("== handshake ==")
    for line in device.log:
        print(line)
    assert device.daw_mode and device.encoder_relative

    print("\n== gestures ==")
    gesture("turn encoder 0 +3", "daw", device.turn_encoder(0, 3))
    gesture("switch to mixer", "daw",
            device.switch_encoder_mode(lk.MIXER))
    # The device dropped relative output on the mode switch; the runner
    # re-asserts it when it handles the mode-change event.
    driver.set_encoder_relative_output()
    gesture("turn encoder 1 -2", "daw", device.turn_encoder(1, -2))
    gesture("press top pad 4", "daw", device.press_top_pad(4))
    gesture("leave DAW pads", "daw",
            device.switch_pad_mode(lk.PAD_MODE_OTHER))
    gesture("pad press while non-DAW (ignored)", "daw",
            device.press_top_pad(4))
    gesture("back to DAW pads", "daw",
            device.switch_pad_mode(lk.PAD_MODE_DAW))
    gesture("function pad", "daw", device.press_function_pad())
    gesture("next track", "daw", device.press_nav("next"))
    gesture("key down", "midi", device.play_key(60, 100))
    gesture("key up (vel 0)", "midi", device.play_key(60, 0))

    print("\n== LED / display pushes ==")
    device.log.clear()
    driver.set_daw_top_pad_color(0, 0, 127, 0)
    driver.set_daw_bottom_pad_color(3, 120, 4, 60)
    driver.set_pad_function_color(lk.COLOR_BRIGHT_GREEN)
    driver.set_daw_mode_display("Clip Launcher")
    driver.set_encoder_display(2, "cutoff", "1.2e+03")
    for line in device.log:
        print(line)

    driver.close()
    print(f"\ndevice state: daw_mode={device.daw_mode} "
          f"pads={len(device.pad_colors)} displays={len(device.displays)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
