"""A binarized conv layer as one NullaNet program, served and checked.

    PYTHONPATH=src python -m repro_torch.examples.serve_conv [--device cpu]
        [--images 25] [--channels 256] [--out-channels 512] [--size 4]

By default VGG16-D's conv8 on CIFAR-10 (3x3 over 256 channels -> 512 on
a 4x4 map, padding 1) with seeded random float32 weights and seeded
random 0/1 input maps: the maps' receptive fields are the ISF the layer
is synthesized from (``flow.conv.conv_to_graph``), the maps are served
through a ``LogicEngine`` (``flow.conv.serve_conv``: rows in, one request,
rows folded back), and the output maps are compared bit for bit with the
plain PyTorch reference (``flow.conv_ref.binarized_conv``, float64, TF32
off) on the same device.  Prints one JSON line: the bits compared and
wrong, the program's size, the synthesis's seconds, and the K2 launch
plan of the served waves (the ``runner.kernel`` span's note).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import obs
from repro_torch.core.spec import CompileSpec
from repro_torch.flow.conv import conv_to_graph, serve_conv
from repro_torch.flow.conv_ref import binarized_conv
from repro_torch.serve import LogicEngine


def run(device=None, images: int = 25, channels: int = 256,
        out_channels: int = 512, size: int = 4, seed: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    maps = rng.integers(0, 2, (images, channels, size, size), dtype=np.uint8)
    weight = rng.standard_normal((out_channels, channels, 3, 3),
                                 dtype=np.float32)
    bias = (0.1 * rng.standard_normal(out_channels, dtype=np.float32))
    with obs.recording():
        graph = conv_to_graph(maps, weight, bias, name="conv")
        engine = LogicEngine(CompileSpec(n_unit=256, optimize="none"),
                             capacity=8192, device=device)
        served = serve_conv(engine, graph, maps)
    want = binarized_conv(maps, weight, bias,
                          device=engine.device).cpu().numpy()
    spans = obs.spans()
    synth = next(s for s in spans if s.label == "nullanet.layer_to_graph")
    plans = {tuple(sorted(s.attrs.items())) for s in spans
             if s.label == "runner.kernel"}
    return {"device": str(engine.device), "shape": list(served.shape),
            "bits": int(want.size),
            "bits_wrong": int((served != want).sum()),
            "fires": int(want.sum()), "gates": graph.n_gates,
            "synthesis": synth.attrs,
            "plans": [dict(p) for p in plans],
            "waves": engine.invocations}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--images", type=int, default=25)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--out-channels", type=int, default=512)
    ap.add_argument("--size", type=int, default=4)
    ap.add_argument("--seed", type=int, default=8)
    args = ap.parse_args()
    out = run(args.device, args.images, args.channels, args.out_channels,
              args.size, args.seed)
    print(json.dumps(out))
    if out["bits_wrong"]:
        raise SystemExit(f"{out['bits_wrong']} of {out['bits']} bits wrong")


if __name__ == "__main__":
    main()
