"""TF32 set through each of torch's spellings, read back by the port.

runtime/torch_compat.py answers whether float32 matmuls may run as TF32
whichever spelling set it, and the port's two float32 guards (the kNN
batch distances, the top-K catalog product) refuse through it. This
script holds that on the card, on the installed torch: for each spelling
— the legacy ``allow_tf32``, the matmul's ``fp32_precision``, the global
``fp32_precision`` that a matmul ``"none"`` inherits, and
``torch.set_float32_matmul_precision("high")`` — it sets TF32, checks
that the helper reads it on, that both guards refuse with the port's own
message (never torch's "mix of the legacy and new APIs" error), that
``set_tf32_matmul(False)`` turns it off leaving every reader working
(``allow_tf32``, ``get_float32_matmul_precision()``), and that the
distances then run.

    python3 scripts/torch_tf32_probe.py

It needs a CUDA device (the guards act only on the card) and exits 2
without one. It prints the torch version, the card's name and power
limit, one line per spelling and, as its last line, a JSON object with
``"ok"``; it exits 1 when a spelling fails.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _readers():
    """What each reader of the flags says now (a raise by its type)."""
    matmul = torch.backends.cuda.matmul
    out = {}
    for name, read in (
            ("allow_tf32", lambda: matmul.allow_tf32),
            ("matmul.fp32_precision", lambda: matmul.fp32_precision),
            ("fp32_precision", lambda: torch.backends.fp32_precision),
            ("get_float32_matmul_precision",
             torch.get_float32_matmul_precision)):
        try:
            out[name] = read()
        except (AttributeError, RuntimeError) as e:
            out[name] = f"raises {type(e).__name__}"
    return out


def _set_legacy():
    torch.backends.cuda.matmul.allow_tf32 = True


def _set_matmul():
    torch.backends.cuda.matmul.fp32_precision = "tf32"


def _set_global():
    torch.backends.fp32_precision = "tf32"
    torch.backends.cuda.matmul.fp32_precision = "none"


def _set_precision():
    torch.set_float32_matmul_precision("high")


SPELLINGS = (("allow_tf32", _set_legacy),
             ("matmul.fp32_precision", _set_matmul),
             ("global fp32_precision", _set_global),
             ("set_float32_matmul_precision", _set_precision))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tf32_probe: no CUDA device", file=sys.stderr)
        return 2
    from hivemall_tpu_torch.knn.distance import euclid_distance_batch
    from hivemall_tpu_torch.runtime.torch_compat import (
        set_tf32_matmul, tf32_matmul_enabled)
    from hivemall_tpu_torch.serving.retrieval import _check_f32_product

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); {smi}")
    print(f"start: helper {tf32_matmul_enabled()}, readers {_readers()}")
    a = torch.randn(4, 8, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    results = {}
    for name, spell in SPELLINGS:
        try:
            spell()
        except (AttributeError, RuntimeError) as e:
            results[name] = f"cannot be set here: {e}"
            print(f"{name}: cannot be set on this torch ({e})")
            continue
        on = tf32_matmul_enabled()
        refusals = []
        for guard in (lambda: euclid_distance_batch(a, a),
                      lambda: _check_f32_product(a)):
            try:
                guard()
                refusals.append("none")
            except RuntimeError as e:
                refusals.append("port" if "in float32: turn TF32 off"
                                in str(e) else f"torch: {str(e)[:60]}")
        set_tf32_matmul(False)
        off = tf32_matmul_enabled()
        readers = _readers()
        ran = tuple(euclid_distance_batch(a, a).shape) == (4, 4)
        good = on and not off and ran and refusals == ["port", "port"] \
            and not any(str(v).startswith("raises")
                        for v in readers.values())
        results[name] = "ok" if good else "FAILED"
        print(f"{name}: helper {on}, refusals {refusals}; after "
              f"set_tf32_matmul(False) helper {off}, readers {readers}, "
              f"distances ran {ran}: {results[name]}")
    ok = all(v == "ok" for v in results.values()
             if not v.startswith("cannot"))
    print(json.dumps({"ok": ok, "torch": torch.__version__,
                      "spellings": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
