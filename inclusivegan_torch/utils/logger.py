"""stdout/stderr tee to ``log.txt`` inside a run dir, copied from
``inclusivegan_tpu/utils/logger.py``: everything printed while a run is
active is mirrored to a file, so that the resume helpers
(``misc.parse_kimg_time_from_log``) and humans can read it.
"""

import sys
from typing import Optional


class Logger:
    """Tee stdout (and optionally stderr) to a file. Re-entrant safe no-op if
    stdout is already a Logger."""

    def __init__(self, file_name: Optional[str] = None, mode: str = "w",
                 should_flush: bool = True):
        self.file = open(file_name, mode) if file_name is not None else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def __enter__(self) -> "Logger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None
