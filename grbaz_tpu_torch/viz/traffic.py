"""P25 traffic pane: live channel-activity tracker (a copy of
``grbaz_tpu/viz/traffic.py``).

Capability equivalent of the reference's wx traffic display
(reference: python/op25_traffic_pane.py:68-156 — a TrafficPane holding
fields duid/nac/source/dest/mfid/algid/kid/mi/tgid, fed by a msgq
watcher thread that unpickles attribute dicts and writes them into the
text controls).  Here the pane is a plain host-side state object: it
consumes decoder event dicts (from the P25 frame-sync event stream or
any message bridge), keeps the current field values plus a bounded
activity log, and renders to text / rows for any front end (terminal,
CSV export, web).  No GUI toolkit dependency.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

# Display order mirrors the reference pane's layout
# (python/op25_traffic_pane.py:76-135).
FIELDS = ("duid", "nac", "source", "dest", "mfid", "algid", "kid", "mi",
          "tgid")

_DUID_NAMES = {
    0x0: "HDU", 0x3: "TDU", 0x5: "LDU1", 0x7: "TSDU", 0xA: "LDU2",
    0xC: "PDU", 0xF: "TDU/LC",
}


def duid_name(duid: int) -> str:
    """Human name for a P25 DUID nibble."""
    return _DUID_NAMES.get(int(duid) & 0xF, f"DUID{int(duid) & 0xF:X}")


class TrafficPane:
    """Current-traffic field tracker with a bounded activity history.

    ``update(attrs)`` applies any subset of FIELDS (extra keys are
    ignored, as the reference's update() skips unknown fields —
    python/op25_traffic_pane.py:150-156); ``clear()`` blanks the pane.
    """

    def __init__(self, history: int = 256,
                 on_update: Optional[Callable[[Dict], None]] = None):
        self._lock = threading.Lock()
        self.fields: Dict[str, str] = {k: "" for k in FIELDS}
        self.log: List[Dict[str, str]] = []
        self._history = int(history)
        self._on_update = on_update
        self.updates = 0

    def update(self, attrs: Dict) -> None:
        with self._lock:
            row = {}
            for k in FIELDS:
                if k in attrs:
                    v = attrs[k]
                    if k == "duid" and not isinstance(v, str):
                        v = duid_name(v)
                    elif not isinstance(v, str):
                        v = (f"0x{v:X}" if k in ("nac", "mfid", "algid",
                                                 "kid") else str(v))
                    self.fields[k] = v
                    row[k] = v
            if row:
                self.updates += 1
                self.log.append(dict(self.fields))
                if len(self.log) > self._history:
                    del self.log[:len(self.log) - self._history]
        if row and self._on_update is not None:
            self._on_update(dict(self.fields))

    def clear(self) -> None:
        """Blank every field (reference clear(), :138-140)."""
        with self._lock:
            for k in FIELDS:
                self.fields[k] = ""

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            return dict(self.fields)

    def render_text(self) -> str:
        snap = self.snapshot()
        w = max(len(k) for k in FIELDS)
        return "\n".join(f"{k.rjust(w)}: {snap[k]}" for k in FIELDS)

    def to_rows(self) -> List[List[str]]:
        """Activity log as rows (for viz.export.write_csv)."""
        with self._lock:
            return [[r.get(k, "") for k in FIELDS] for r in self.log]


def frame_sync_events_to_attrs(nacs, duids) -> List[Dict[str, int]]:
    """Convert P25FrameSync event arrays (per-frame NAC/DUID, see
    grbaz_tpu_torch/ops/p25.py) into pane attribute dicts."""
    return [{"nac": int(n), "duid": int(d)} for n, d in zip(nacs, duids)]
