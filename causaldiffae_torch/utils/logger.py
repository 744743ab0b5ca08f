"""KV logger with mean aggregation, multiple output formats, and profiling.

The port's own copy of ``causaldiffae_tpu/utils/logger.py`` (the OpenAI
baselines logger): ``logkv``/``logkv_mean``/``dumpkvs`` with
Human/CSV/JSON/TensorBoard writers selected by env or argument,
``profile_kv`` wall-time scopes, and a global default logger. Differences:
the default directory is under ``tempfile.gettempdir()`` (which honours
``TMPDIR``); a logger with no output formats, or only ``stdout``/``stderr``
(the latter a format of the port's), makes no directory, and the
logger used before any ``configure`` is one (the train loop prints its own
JSON line per record); and a CSV file that already has rows (a resumed run)
keeps its header, so the new rows line up with the old ones.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import os.path as osp
import sys
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

__all__ = [
    "KVWriter",
    "HumanOutputFormat",
    "JSONOutputFormat",
    "CSVOutputFormat",
    "Logger",
    "configure",
    "close",
    "get_current",
    "logkv",
    "logkv_mean",
    "dumpkvs",
    "log",
    "profile_kv",
]


class KVWriter:
    def writekvs(self, kvs: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class HumanOutputFormat(KVWriter):
    """Boxed key | value table (reference `logger.py:36-80`)."""

    def __init__(self, filename_or_file):
        self._file = None  # None = late-bind to the CURRENT sys.stdout / sys.stderr
        self._stream = "stderr" if filename_or_file is sys.stderr else "stdout"
        if isinstance(filename_or_file, str):
            self._file = open(filename_or_file, "at")
            self.own_file = True
        else:
            # "stdout" must mean the stdout of the moment, not the object at
            # configure() time: under pytest's capture, sys.stdout is a
            # per-test file that gets CLOSED at test end, and a module-global
            # Logger holding it poisons every later log() call.
            if filename_or_file not in (sys.stdout, sys.stderr):
                self._file = filename_or_file
            self.own_file = False

    @property
    def file(self):
        return getattr(sys, self._stream) if self._file is None else self._file

    def writekvs(self, kvs):
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[self._truncate(key)] = self._truncate(valstr)
        if not key2str:
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in sorted(key2str.items()):
            lines.append(f"| {key}{' ' * (keywidth - len(key))} | {val}{' ' * (valwidth - len(val))} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    @staticmethod
    def _truncate(s, maxlen=30):
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s

    def close(self):
        if self.own_file:
            self.file.close()


class JSONOutputFormat(KVWriter):
    def __init__(self, filename):
        self.file = open(filename, "at")

    def writekvs(self, kvs):
        out = {k: float(v) if hasattr(v, "__float__") else v for k, v in kvs.items()}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    """CSV with on-the-fly header extension (reference `logger.py:109-145`)."""

    def __init__(self, filename):
        self.filename = filename
        self.file = open(filename, "a+t")
        self.sep = ","
        # a resumed run appends to its file: start from the header there, so
        # that its rows line up with the earlier ones (the JAX logger starts
        # from no keys and pads every earlier row by the whole header)
        self.file.seek(0)
        header = self.file.readline().rstrip("\n")
        self.keys: List[str] = header.split(self.sep) if header else []
        self.file.seek(0, os.SEEK_END)

    def writekvs(self, kvs):
        extra_keys = list(kvs.keys() - self.keys)
        if extra_keys:
            self.keys.extend(sorted(extra_keys))
            self.file.seek(0)
            lines = self.file.readlines()
            self.file.seek(0)
            self.file.truncate()
            self.file.write(self.sep.join(self.keys) + "\n")
            for line in lines[1:]:
                self.file.write(line.rstrip("\n") + self.sep * len(extra_keys) + "\n")
        vals = []
        for k in self.keys:
            v = kvs.get(k)
            vals.append("" if v is None else str(float(v) if hasattr(v, "__float__") else v))
        self.file.write(self.sep.join(vals) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


STREAMS = ("stdout", "stderr")  # formats that write no file


def make_output_format(fmt: str, ev_dir: Optional[str], log_suffix: str = "") -> KVWriter:
    if fmt in STREAMS:
        return HumanOutputFormat(getattr(sys, fmt))
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "log":
        return HumanOutputFormat(osp.join(ev_dir, f"log{log_suffix}.txt"))
    if fmt == "json":
        return JSONOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.csv"))
    if fmt == "tensorboard":
        from .tensorboard import TensorBoardWriter

        return TensorBoardWriter(osp.join(ev_dir, f"tb{log_suffix}"))
    raise ValueError(f"unknown format: {fmt}")


class Logger:
    def __init__(self, dir: Optional[str], output_formats: List[KVWriter]):
        self.name2val: Dict[str, float] = defaultdict(float)
        self.name2cnt: Dict[str, int] = defaultdict(int)
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        """Running mean until the next dump (reference `logger.py:221-233,350-353`)."""
        if val is None:
            self.name2val[key] = None
            return
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        out = dict(self.name2val)
        for fmt in self.output_formats:
            fmt.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args):
        for fmt in self.output_formats:
            if isinstance(fmt, HumanOutputFormat):
                fmt.file.write(" ".join(map(str, args)) + "\n")
                fmt.file.flush()

    def close(self):
        for fmt in self.output_formats:
            fmt.close()


_CURRENT: Optional[Logger] = None


def configure(dir: Optional[str] = None, format_strs: Optional[List[str]] = None,
              log_suffix: str = "") -> Logger:
    """Set up the global logger (reference `logger.py:442-472`: OPENAI_LOGDIR /
    OPENAI_LOG_FORMAT envs honored), closing the one it replaces."""
    global _CURRENT
    if format_strs is None:
        format_strs = os.environ.get("OPENAI_LOG_FORMAT", "stdout,log,csv").split(",")
    format_strs = [f for f in format_strs if f]
    if dir is None:
        dir = os.environ.get("OPENAI_LOGDIR")
    if dir is None and any(f not in STREAMS for f in format_strs):
        dir = osp.join(
            tempfile.gettempdir(),
            "causaldiffae-" + datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S-%f"),
        )
    if dir is not None:
        os.makedirs(dir, exist_ok=True)
    if _CURRENT is not None:
        _CURRENT.close()
    _CURRENT = Logger(dir, [make_output_format(f, dir, log_suffix) for f in format_strs])
    return _CURRENT


def close() -> None:
    """Close the global logger's files; the next call makes one that writes nothing."""
    global _CURRENT
    if _CURRENT is not None:
        _CURRENT.close()
    _CURRENT = None


def get_current() -> Logger:
    global _CURRENT
    if _CURRENT is None:  # unconfigured: keep the values, write nothing
        _CURRENT = configure(format_strs=[])
    return _CURRENT


def logkv(key, val):
    get_current().logkv(key, val)


def logkv_mean(key, val):
    get_current().logkv_mean(key, val)


def dumpkvs():
    return get_current().dumpkvs()


def log(*args):
    get_current().log(*args)


@contextlib.contextmanager
def profile_kv(scopename: str):
    """Accumulate wall time under wait_<scope> (reference `logger.py:294-311`)."""
    logkey = "wait_" + scopename
    tstart = time.time()
    try:
        yield
    finally:
        get_current().name2val[logkey] += time.time() - tstart

