"""ACARS packet formatting (python/acars_printer.py equivalent).

Parses the byte rows emitted by
:class:`grbaz_tpu_torch.ops.decode.ACARSDecoder` (``[n_bytes, parity_errors,
byte0, ...]``) into the standard ACARS fields and renders them as text
the way the reference's printer thread did.

Packet layout after SOH (ARINC 618): mode(1) address(7) ack(1) label(2)
block-id(1) STX text... ETX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

SOH, STX, ETX, DEL = 0x01, 0x02, 0x03, 0x7F


def parse_packet(row) -> Optional[dict]:
    """One event row -> field dict (None if too short to parse)."""
    row = np.asarray(row)
    n = int(row[0])
    parity_errors = int(row[1])
    data = bytes(int(b) & 0xFF for b in row[2:2 + n])
    if len(data) < 14:
        return None
    body = data[1:] if data[0] == SOH else data
    fields = dict(
        mode=chr(body[0]),
        address=bytes(body[1:8]).decode(errors="replace").strip("."),
        ack=chr(body[8]) if body[8] != 0x15 else "NAK",
        label=bytes(body[9:11]).decode(errors="replace"),
        block_id=chr(body[11]),
        parity_errors=parity_errors,
        raw=data,
    )
    text = ""
    if len(body) > 12 and body[12] == STX:
        payload = body[13:]
        end = payload.find(ETX)
        if end >= 0:
            payload = payload[:end]
        text = payload.decode(errors="replace")
    fields["text"] = text
    # downlinks carry a seq number + flight id at the head of the text
    if len(text) >= 10 and fields["block_id"] not in "X":
        fields["seq_no"] = text[:4]
        fields["flight"] = text[4:10]
        fields["message"] = text[10:]
    else:
        fields["message"] = text
    return fields


def format_packet(row) -> str:
    """Render one event row as a display line (acars_printer style)."""
    f = parse_packet(row)
    if f is None:
        return "(short/unparseable ACARS packet)"
    head = (f"ACARS mode={f['mode']} addr={f['address']} ack={f['ack']} "
            f"label={f['label']} blk={f['block_id']}")
    if f.get("flight"):
        head += f" flight={f['flight']} seq={f['seq_no']}"
    if f["parity_errors"]:
        head += f" [{f['parity_errors']} parity errors]"
    msg = f.get("message", "")
    return head + (f"\n  {msg}" if msg else "")
