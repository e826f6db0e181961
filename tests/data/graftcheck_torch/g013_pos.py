"""G013 positive fixture (graftcheck/g013_pos.py's twin, line for line):
a .cpu() sync, sleep, file IO, Future completion under a lock."""
# graftcheck: serving-module

import threading
import time

import torch


class SwapRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}

    def publish(self, name, value):
        with self._lock:
            host = value.cpu()  # EXPECT: G013
            self._entries[name] = host

    def slow_swap(self, name, value):
        with self._lock:
            time.sleep(0.1)  # EXPECT: G013
            self._entries[name] = value

    def persist(self, name):
        with self._lock:
            with open("/tmp/graftcheck_fixture", "w") as fh:  # EXPECT: G013
                fh.write(repr(self._entries.get(name)))

    def drain(self, futures):
        with self._lock:
            self._fail_all(futures)

    def _fail_all(self, futures):
        for f in futures:
            f.set_exception(RuntimeError("closed"))  # EXPECT: G013
