"""World-map node visualization + animated GIF.

Reference semantics: tools/NodeDrawer.java:24-286 (+ GifSequenceWriter):
nodes drawn as SIZE x SIZE dots on the world map, colored red -> yellow
-> green by a protocol-provided value, 'special' nodes marked, positions
allocated once on first sight via an outward spiral so dots never overlap
and never move between frames.  Frames accumulate palette-quantized and
are written as an animated GIF by PIL on close().  Drawing is host work:
PIL is imported only where a drawer is made or draws, so a host without
PIL still runs the simulation that feeds it.

The map is the port's own copy, `data/world_map_2000px.png`.  The
NodeStatus plug-in interface is the reference's (NodeDrawer.NodeStatus,
:30-48): get_val / is_special / get_max / get_min.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.geo import MAX_X, MAX_Y

SIZE = 5  # dot size in pixels (NodeDrawer.java:25)
WORLD_MAP = Path(__file__).resolve().parent.parent / "data" / "world_map_2000px.png"


class NodeStatus:
    """Protocol-status plug-in (NodeDrawer.NodeStatus, :30-48)."""

    def get_val(self, n) -> int:
        raise NotImplementedError

    def is_special(self, n) -> bool:
        raise NotImplementedError

    def get_max(self) -> int:
        raise NotImplementedError

    def get_min(self) -> int:
        raise NotImplementedError


def _make_color(value: int) -> Tuple[int, int, int]:
    """Red -> yellow -> green ramp over [0, 510] (NodeDrawer.java:208-230)."""
    value = min(max(0, value), 510)
    if value < 255:
        red = 255
        green = int(math.sqrt(value) * 16)
    else:
        green = 255
        value = value - 255
        red = 255 - (value * value // 255)
    return red, green, 0


class NodeDrawer:
    """Draw per-tick node states; optionally stream frames to a GIF."""

    def __init__(self, node_status: NodeStatus, animated_dest: Optional[str] = None,
                 frequency_ms: int = 10):
        from PIL import Image

        self.status = node_status
        self.min = node_status.get_min() - 1  # avoid division by zero (:88)
        self.max = node_status.get_max()
        if self.min >= self.max or self.min < -1:
            raise ValueError(f"bad values for min={node_status.get_min()} or "
                             f"max={node_status.get_max()}")
        self.background = Image.open(WORLD_MAP).convert("RGB")
        self.dots = np.zeros((MAX_X, MAX_Y), dtype=bool)
        self.node_pos: Dict[int, Tuple[int, int]] = {}
        self.last_img = None
        self._dest = animated_dest
        self._frequency_ms = frequency_ms
        self._frames: List = []  # palette-quantized to bound memory

    # -- stable non-overlapping dot allocation (NodeDrawer.java:117-205) ----
    def _is_free(self, x: int, y: int) -> bool:
        if x < 1 or x >= MAX_X - SIZE or y < 1 or y >= MAX_Y - SIZE:
            return False
        return not self.dots[x: x + SIZE, y: y + SIZE].any()

    def _find_pos(self, n) -> Tuple[int, int]:
        pos = self.node_pos.get(n.node_id)
        if pos is not None:
            return pos
        delta_x = delta_y = 0
        was_x = False
        distance = 0
        while distance < 200:
            for x in range(max(1, n.x - delta_x), min(MAX_X, n.x + delta_x), SIZE):
                for y in range(max(1, n.y - delta_y), min(MAX_Y, n.y + delta_y), SIZE):
                    d = math.hypot((x - n.x) * SIZE, (y - n.y) * SIZE)
                    if d <= distance * SIZE and self._is_free(x, y):
                        self.dots[x: x + SIZE, y: y + SIZE] = True
                        self.node_pos[n.node_id] = (x, y)
                        return x, y
            if was_x:
                delta_y += SIZE
            else:
                delta_x += SIZE
            was_x = not was_x
            distance += 1
        raise RuntimeError(f"No free room for node {n.node_id}, x={n.x}, y={n.y}")

    # -- frames --------------------------------------------------------------
    def draw_new_state(self, time_ms: int, live_nodes: List) -> None:
        from PIL import ImageDraw

        img = self.background.copy()
        draw = ImageDraw.Draw(img)
        for n in live_nodes:
            x, y = self._find_pos(n)
            val = self.status.get_val(n)
            ratio = (val - self.min) / (self.max - self.min)
            color = _make_color(int(510 * ratio))
            draw.rectangle([x, y, x + SIZE - 1, y + SIZE - 1], fill=color)
            if self.status.is_special(n):
                draw.point((x + SIZE // 2, y + SIZE // 2), fill=(0, 0, 255))
        # white-on-dark with a shadow so the stamp reads on the map corner
        draw.text((11, 11), f"{time_ms} ms", fill=(0, 0, 0))
        draw.text((10, 10), f"{time_ms} ms", fill=(255, 255, 255))
        self.last_img = img
        if self._dest is not None:
            self._frames.append(img.convert("P", palette="ADAPTIVE"))

    def write_last_to_png(self, dest: str) -> None:
        if self.last_img is None:
            raise RuntimeError("no frame drawn yet")
        self.last_img.save(dest)

    def close(self) -> None:
        if self._dest is not None and self._frames:
            self._frames[0].save(
                self._dest,
                save_all=True,
                append_images=self._frames[1:],
                duration=self._frequency_ms,
                loop=0,
            )
            self._dest = None
            self._frames = []

    def __enter__(self) -> "NodeDrawer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
