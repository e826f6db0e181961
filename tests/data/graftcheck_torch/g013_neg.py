"""G013 negative fixture (graftcheck/g013_neg.py's twin, line for line):
the collect-under-lock / act-outside idiom, waiting on the held CV, and
blocking work with no lock held — zero findings."""
# graftcheck: serving-module

import threading
import time

import torch


class GoodBatcher:
    def __init__(self):
        self._cv = threading.Condition()
        self._q = []
        self._closed = False

    def take_and_score(self):
        with self._cv:
            while not self._q:
                if self._closed:
                    return []
                self._cv.wait(timeout=0.1)  # waiting on the HELD cv: idiom
            batch = list(self._q)
            self._q.clear()
        # device work happens OUTSIDE the lock
        return torch.stack(batch).cpu()

    def close(self):
        with self._cv:
            self._closed = True
            pending = list(self._q)
            self._q.clear()
            self._cv.notify_all()
        # Future completion outside the lock: callbacks run unlocked
        for f in pending:
            f.set_exception(RuntimeError("closed"))


def unlocked_warmup(engine):
    # blocking is fine when nothing is held
    time.sleep(0.01)
    return engine.cpu()
