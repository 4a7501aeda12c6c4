"""TSV storage: rows of base64 frames with a ``.lineidx`` sidecar of row
offsets (counterpart of ``empirical_mvm_tpu/data/tsv.py``; ref:
utils/tsv_file.py:43 ``TSVFile``, :114 ``CompositeTSVFile``;
utils/tsv_file_ops.py:34, 127 ``tsv_reader`` / ``tsv_writer``).

:class:`TSVFile` seeks a row through the sidecar and re-opens its file
after a fork. It is the plain version of ``data/native_tsv.py``'s reader.
Writes go through an atomic rename.
"""

from __future__ import annotations

import logging
import os
import os.path as op
import threading
from typing import Iterable, Iterator, Sequence

from empirical_mvm_torch.core.retry import retry_io

logger = logging.getLogger(__name__)


def generate_lineidx(tsv_path: str, idx_path: str) -> None:
    """Build the byte-offset sidecar (ref: utils/tsv_file_ops.py lineidx gen).
    Each process writes its own temporary file: ranks that open the same
    TSV at once each rename a whole sidecar into place."""
    offsets = []
    with open(tsv_path, "rb") as f:
        pos = 0
        for line in f:
            offsets.append(pos)
            pos += len(line)
    tmp = f"{idx_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(str(o) for o in offsets) + ("\n" if offsets else ""))
    os.replace(tmp, idx_path)


def load_lineidx(idx_path: str) -> list[int]:
    with open(idx_path) as f:
        return [int(line) for line in f if line.strip()]


class TSVFile:
    """Random-access TSV with a ``.lineidx`` sidecar (ref: utils/tsv_file.py:43).

    Lazily opens; re-opens automatically if the process forked since the last
    read (ref: utils/tsv_file.py:103-111).
    """

    def __init__(self, tsv_path: str, generate_lineidx_if_missing: bool = False):
        self.tsv_path = tsv_path
        self.lineidx_path = op.splitext(tsv_path)[0] + ".lineidx"
        if not op.isfile(self.lineidx_path) and generate_lineidx_if_missing:
            generate_lineidx(tsv_path, self.lineidx_path)
        self._lineidx: list[int] | None = None
        self._fp = None
        self._pid: int | None = None
        # seek+readline is a two-step critical section on one shared handle;
        # loader producer threads (data/loader.py) read concurrently, so an
        # unlocked pair interleaves and yields garbage rows.
        self._lock = threading.Lock()

    def _ensure_lineidx(self) -> list[int]:
        if self._lineidx is None:
            self._lineidx = load_lineidx(self.lineidx_path)
        return self._lineidx

    def _ensure_fp(self):
        if self._fp is None or self._pid != os.getpid():
            if self._fp is not None and self._pid != os.getpid():
                logger.debug("re-opening %s after fork", self.tsv_path)
            self._fp = open(self.tsv_path, "rb")
            self._pid = os.getpid()
        return self._fp

    def num_rows(self) -> int:
        return len(self._ensure_lineidx())

    def __len__(self) -> int:
        return self.num_rows()

    def seek(self, idx: int) -> list[str]:
        offsets = self._ensure_lineidx()

        def read() -> bytes:
            with self._lock:
                fp = self._ensure_fp()
                try:
                    fp.seek(offsets[idx])
                    return fp.readline()
                except OSError:
                    # transient FS error: drop the handle so the retry reopens
                    self._fp = None
                    raise

        raw = retry_io(read, what=f"tsv read {self.tsv_path}")
        return [s.decode("utf-8") for s in raw.rstrip(b"\r\n").split(b"\t")]

    def __getitem__(self, idx: int) -> list[str]:
        return self.seek(idx)

    def get_key(self, idx: int) -> str:
        return self.seek(idx)[0]

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


class CompositeTSVFile:
    """A virtual TSV spanning shard files (ref: utils/tsv_file.py:114-158).

    ``list_file`` is either a list of shard paths or a path to a text file of
    shard paths; ``seq_file`` maps a global row to (shard_idx, row_idx) pairs
    like the reference's caption_linelist.
    """

    def __init__(self, list_file: str | Sequence[str], seq_file: str,
                 root: str = "."):
        if isinstance(list_file, str):
            with open(op.join(root, list_file)) as f:
                shards = [line.strip() for line in f if line.strip()]
        else:
            shards = list(list_file)
        self.shards = [TSVFile(op.join(root, s)) for s in shards]
        self.seq: list[tuple[int, int]] = []
        with open(op.join(root, seq_file)) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    self.seq.append((int(parts[0]), int(parts[1])))

    def num_rows(self) -> int:
        return len(self.seq)

    def __len__(self) -> int:
        return self.num_rows()

    def __getitem__(self, idx: int) -> list[str]:
        shard_idx, row_idx = self.seq[idx]
        return self.shards[shard_idx][row_idx]

    def get_key(self, idx: int) -> str:
        shard_idx, row_idx = self.seq[idx]
        return f"{shard_idx}_{self.shards[shard_idx].get_key(row_idx)}"

    def get_composite_source_idx(self) -> list[int]:
        return [s for s, _ in self.seq]


def tsv_reader(tsv_path: str) -> Iterator[list[str]]:
    """Streaming reader (ref: utils/tsv_file_ops.py:34)."""
    with open(tsv_path) as f:
        for line in f:
            yield line.rstrip("\r\n").split("\t")


def tsv_writer(rows: Iterable[Sequence[object]], tsv_path: str) -> None:
    """Write rows + lineidx atomically (ref: utils/tsv_file_ops.py:127)."""
    os.makedirs(op.dirname(op.abspath(tsv_path)), exist_ok=True)
    idx_path = op.splitext(tsv_path)[0] + ".lineidx"
    tmp_tsv, tmp_idx = tsv_path + ".tmp", idx_path + ".tmp"
    with open(tmp_tsv, "wb") as f, open(tmp_idx, "w") as fidx:
        pos = 0
        for row in rows:
            line = ("\t".join(str(c) for c in row) + "\n").encode("utf-8")
            fidx.write(f"{pos}\n")
            f.write(line)
            pos += len(line)
    os.replace(tmp_tsv, tsv_path)
    os.replace(tmp_idx, idx_path)
