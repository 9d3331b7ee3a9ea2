"""Batched serving demo: continuous batching over the decode engine.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The port's counterpart of ``examples/serve_lm.py``: a thin wrapper over
``repro_torch.launch.serve``'s defaults (qwen3-8b's smoke config), on the
card unless ``--device cpu``; further arguments pass through.
"""
import sys

from repro_torch.launch import serve

if __name__ == "__main__":
    serve.main(["--arch", "qwen3-8b", "--smoke", "--requests", "8",
                "--batch-size", "4", "--prompt-len", "12", "--max-new", "6"]
               + sys.argv[1:])
