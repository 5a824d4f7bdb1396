"""Server-Sent-Events framing (the true-streaming transport).

The port's copy of the reference's ``repro/obs/sse.py``, unchanged.

Both ends of the wire live here so the framing can't drift: the server
side of ``GET /v1/jobs/{id}/logs``, ``.../status`` and ``GET /v2/events``
emits frames with :func:`format_event` / :func:`format_comment`, and the
client side (``HttpTransport.stream_*``) parses the byte stream back with
:func:`iter_sse`.

Dialect (the standard text/event-stream subset we pin in docs/api.md):

  * ``data:`` lines carry one JSON document per frame (multi-line data is
    rejoined with ``\\n`` by the parser);
  * ``id:`` carries the resume cursor — a client reconnecting sends it
    back as the ``Last-Event-ID`` header and the stream picks up exactly
    after it (the exactly-once contract across disconnects);
  * ``event:`` names the frame: default ``message`` (a payload),
    ``status`` (a status change), ``end`` (terminal — the server is done
    and will close), ``error`` (a mid-stream failure carrying the
    standard error envelope as data);
  * ``: hb`` comment frames are heartbeats — they keep idle connections
    demonstrably alive and carry no data. The parser yields them with
    ``comment`` set so callers (and the benchmark) can count cadence.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterator, Optional

SSE_CONTENT_TYPE = "text/event-stream"


@dataclass
class SseMessage:
    data: Optional[str] = None
    event: str = "message"
    id: Optional[str] = None
    comment: Optional[str] = None

    def json(self):
        """Decode the data payload (frames carry one JSON doc)."""
        return json.loads(self.data) if self.data is not None else None


def format_event(data, event: Optional[str] = None,
                 id: Optional[str] = None) -> bytes:
    """One wire frame. ``data`` may be a str (pre-encoded JSON) or any
    JSON-serialisable object."""
    if not isinstance(data, str):
        data = json.dumps(data)
    lines = []
    if event is not None and event != "message":
        lines.append(f"event: {event}")
    if id is not None:
        lines.append(f"id: {id}")
    for part in data.split("\n"):  # payload newlines become data: lines
        lines.append(f"data: {part}")
    return ("\n".join(lines) + "\n\n").encode("utf-8")


def format_comment(text: str = "hb") -> bytes:
    return f": {text}\n\n".encode("utf-8")


def iter_sse(fp) -> Iterator[SseMessage]:
    """Parse an SSE byte stream from a file-like object (``readline`` is
    enough — http.client responses decode chunked transfer transparently).
    Yields one :class:`SseMessage` per blank-line-terminated frame, comment
    frames included; returns on EOF."""
    data_lines: list[str] = []
    event: str = "message"
    id_: Optional[str] = None
    comment: Optional[str] = None
    while True:
        raw = fp.readline()
        if not raw:  # EOF: server closed (clean close or cut)
            return
        line = raw.decode("utf-8", errors="replace").rstrip("\r\n")
        if line == "":
            if data_lines or comment is not None or id_ is not None:
                yield SseMessage(
                    data="\n".join(data_lines) if data_lines else None,
                    event=event, id=id_, comment=comment)
            data_lines, event, id_, comment = [], "message", None, None
            continue
        if line.startswith(":"):
            comment = line[1:].lstrip(" ")
            continue
        field, _, value = line.partition(":")
        value = value[1:] if value.startswith(" ") else value
        if field == "data":
            data_lines.append(value)
        elif field == "event":
            event = value
        elif field == "id":
            id_ = value
