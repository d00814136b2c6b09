"""Run logging (``nmf_tpu/logging_utils.py``): every run appends one JSON
object per event to ``metrics.jsonl`` in its folder (the scalars file of
nmf_tpu's run folders). A resumed run appends to the same file, and its
clock ``t`` continues from the last one recorded. nmf_tpu's TensorBoard
mirror is left out: where tensorboard is installed, importing its writer
imports TensorFlow, tens of seconds a process."""
import json
import time
from pathlib import Path


class RunLogger:
    def __init__(self, logdir, echo=print):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        mfile = self.logdir / "metrics.jsonl"
        prev_t = 0.0
        if mfile.exists():
            try:
                for line in mfile.read_text().splitlines()[::-1]:
                    rec = json.loads(line)
                    if "t" in rec:
                        prev_t = float(rec["t"])
                        break
            except (ValueError, OSError):
                pass
        self._f = open(mfile, "a")
        self._echo = echo
        self._t0 = time.time() - prev_t

    def scalars(self, step, **kwargs):
        rec = {"step": step, "t": round(time.time() - self._t0, 3), **kwargs}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def info(self, msg):
        self._echo(msg)
        self._f.write(json.dumps({"log": msg,
                                  "t": round(time.time() - self._t0, 3)})
                      + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
