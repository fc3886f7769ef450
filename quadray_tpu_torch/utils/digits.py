"""On-frame 5x7 digit counters (render_num analog, engine.cpp:3846-4000):
draws fps / config numbers directly into the frame buffer. A copy of
``quadray_tpu.utils.digits`` (numpy only)."""

from __future__ import annotations

import numpy as np

# 5x7 bitmap font for digits 0-9 (rows top->bottom, 5-bit masks)
_FONT = {
    "0": [0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E],
    "1": [0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E],
    "2": [0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F],
    "3": [0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E],
    "4": [0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02],
    "5": [0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E],
    "6": [0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E],
    "7": [0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08],
    "8": [0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E],
    "9": [0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C],
    ".": [0x00, 0x00, 0x00, 0x00, 0x00, 0x0C, 0x0C],
    " ": [0x00] * 7,
}


def draw_number(frame: np.ndarray, text: str, x: int = 2, y: int = 2,
                color=(255, 255, 255)) -> np.ndarray:
    """Draw `text` (digits, dot, space) into frame at (x, y) in place."""
    h, w = frame.shape[:2]
    cx = x
    for ch in text:
        glyph = _FONT.get(ch)
        if glyph is None:
            cx += 6
            continue
        for ry, bits in enumerate(glyph):
            for rx in range(5):
                if bits & (1 << (4 - rx)):
                    yy, xx = y + ry, cx + rx
                    if 0 <= yy < h and 0 <= xx < w:
                        frame[yy, xx] = color
        cx += 6
    return frame
