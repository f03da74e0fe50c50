"""Training metrics logger: 100-step-averaged scalars, appended to a JSONL
file and, when TensorBoard is installed, written as TensorBoard scalars.
"""

import json
import os
import time


class Logger:
    SUM_FREQ = 100

    def __init__(self, name, log_dir="runs"):
        self.name = name
        self.dir = os.path.join(log_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.running = {}
        self.count = 0
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self.writer = SummaryWriter(self.dir)
        self.jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")

    def push(self, metrics, step):
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        self.count += 1
        if self.count >= self.SUM_FREQ:
            self.flush(step)

    def _write(self, avg, step):
        if self.writer is not None:
            for k, v in avg.items():
                self.writer.add_scalar(k, v, step)
        self.jsonl.write(json.dumps(
            {"step": step, "time": time.time(), **avg}) + "\n")
        self.jsonl.flush()

    def flush(self, step=0):
        if self.count:
            avg = {k: v / self.count for k, v in self.running.items()}
            self._write(avg, step)
            self.running = {}
            self.count = 0

    def close(self):
        self.jsonl.close()
        if self.writer is not None:
            self.writer.close()
