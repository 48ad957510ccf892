"""Observability: per-session ring-buffer logging and stream capture (a
copy of ``tpinn.utils.logging``, so that the port imports nothing from
``tpinn``).

Each browser session gets its own thread-safe ring buffer, fed directly
by the training loop's log lines; ``Tee`` and ``redirect_std_streams``
keep the capture-everything behaviour for the app entry points.
"""

from __future__ import annotations

import logging
import sys
import threading
from collections import deque
from typing import Deque, Dict, Iterable


class LogBuffer:
    """Thread-safe bounded log ring."""

    def __init__(self, maxlen: int = 1000):
        self._buf: Deque[str] = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def append(self, line: str) -> None:
        with self._lock:
            self._buf.append(line)

    def extend(self, lines: Iterable[str]) -> None:
        with self._lock:
            self._buf.extend(lines)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def lines(self) -> list:
        with self._lock:
            return list(self._buf)

    def text(self) -> str:
        return "\n".join(self.lines())

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


class SessionLogs:
    """Registry of per-session LogBuffers (no process-global buffer that
    concurrent sessions would interleave in)."""

    def __init__(self, maxlen: int = 1000):
        self._sessions: Dict[str, LogBuffer] = {}
        self._lock = threading.Lock()
        self._maxlen = maxlen

    def get(self, session_id: str) -> LogBuffer:
        with self._lock:
            if session_id not in self._sessions:
                self._sessions[session_id] = LogBuffer(self._maxlen)
            return self._sessions[session_id]

    def drop(self, session_id: str) -> None:
        with self._lock:
            self._sessions.pop(session_id, None)


def format_step_line(step: int, loss_info) -> str:
    """The reference's per-100-step progress line."""
    return (
        f"Step: {step} | Loss: {float(loss_info[0]):.4e} |"
        f" Loss_d: {float(loss_info[1]):.4e} | Loss_e: {float(loss_info[2]):.4e} | "
    )


def make_log_fn(buffer: LogBuffer, echo: bool = False):
    """Callback for the Adam phase's (step, loss_info) log stream."""

    def log_fn(step, loss_info):
        line = format_step_line(int(step), loss_info)
        buffer.append(line)
        if echo:
            print(line, file=sys.stderr)

    return log_fn


class BufferHandler(logging.Handler):
    """logging.Handler that appends formatted records to a LogBuffer."""

    def __init__(self, buffer: LogBuffer, level=logging.INFO):
        super().__init__(level)
        self.buffer = buffer
        self.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))

    def emit(self, record):
        try:
            self.buffer.append(self.format(record))
        except Exception:  # pragma: no cover
            self.handleError(record)


class Tee:
    """Mirror writes to the original stream AND a LogBuffer, so that stray
    prints from libraries still reach the UI log."""

    def __init__(self, stream, buffer: LogBuffer):
        self._stream = stream
        self._buffer = buffer
        self._partial = ""

    def write(self, s: str):
        self._stream.write(s)
        self._partial += s
        while "\n" in self._partial:
            line, self._partial = self._partial.split("\n", 1)
            if line.strip():
                self._buffer.append(line)
        return len(s)

    def flush(self):
        self._stream.flush()

    def isatty(self):
        return False

    def fileno(self):
        return self._stream.fileno()


def redirect_std_streams(buffer: LogBuffer):
    """Install Tee wrappers on sys.stdout / sys.stderr."""
    sys.stdout = Tee(sys.stdout, buffer)
    sys.stderr = Tee(sys.stderr, buffer)
