"""End-to-end NullaNet classifier (paper §7-§8): train -> FFCL -> serve -> acc.

    PYTHONPATH=src python -m repro_torch.examples.e2e_nullanet [--quick]
        [--device cpu] [--json PATH]

The port's counterpart of ``examples/e2e_nullanet.py``, the whole paper
loop as one artifact (``repro_torch.flow``):

1. Trains a binarized MLP AND a float (ReLU) upper-bound MLP on a
   synthetic classification task (MNIST stand-in; datasets are
   offline-unavailable), on ``--device`` (CUDA unless told otherwise).
2. Converts EVERY hidden layer to fixed-function combinational logic
   through the single flow conversion path (ISF/enumeration -> espresso ->
   gate factoring -> synth -> sub-kernel scheduling).
3. Executes the chained logic stack — input binarization, packed-word
   layer handoff, numeric argmax head — through all four backends: the
   plain PyTorch executor, the CUDA program kernel (one launch per layer),
   the megakernel (one launch for the stack), and batched LogicEngine
   serving.  On ``--device cpu`` the kernels' plain versions run instead.
4. Reports accuracy parity (float / binarized / logic), per-layer gate &
   step counts, and the pipelined-simulator cycle estimate.

With the default configuration every layer fanin admits full input
enumeration, so the logic computes exactly the binarized model's function:
the script *asserts* logic acc == binarized acc and bit-identical hidden
activations across backends.
"""
import argparse
import json

from repro_torch.core.spec import CompileSpec
from repro_torch.flow import FlowConfig, run_flow


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="smaller task + fewer train steps (~8s)")
    ap.add_argument("--features", type=int, default=12)
    ap.add_argument("--hidden", default="10,8",
                    help="comma-separated hidden widths")
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--samples", type=int, default=None,
                    help="default 4000 (1500 with --quick)")
    ap.add_argument("--train-steps", type=int, default=None,
                    help="default 300 (120 with --quick)")
    ap.add_argument("--n-unit", default="32",
                    help="compute units, or 'auto' for the paper §7.2 "
                         "design-space search per layer (CompileSpec)")
    ap.add_argument("--alloc", choices=("direct", "liveness"),
                    default="liveness")
    ap.add_argument("--mode", choices=("auto", "enum", "isf"), default="auto")
    ap.add_argument("--optimize", choices=("default", "none"),
                    default="default",
                    help="gate-level pass pipeline (core/opt.py); 'none' "
                         "keeps raw espresso factoring for A/B comparison")
    ap.add_argument("--max-gates", type=int, default=None,
                    help="engine partition budget (pipelined sub-programs)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; raises without a GPU) or 'cpu' "
                         "for the plain PyTorch executors")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the report as JSON")
    args = ap.parse_args()

    hidden = tuple(int(h) for h in args.hidden.split(",") if h)
    quick_default = lambda given, quick, full: \
        given if given is not None else (quick if args.quick else full)
    spec = CompileSpec(
        n_unit="auto" if args.n_unit == "auto" else int(args.n_unit),
        alloc=args.alloc, optimize=args.optimize, max_gates=args.max_gates)
    cfg = FlowConfig(
        n_features=args.features, hidden=hidden, n_classes=args.classes,
        n_samples=quick_default(args.samples, 1500, 4000),
        train_steps=quick_default(args.train_steps, 120, 300),
        spec=spec, mode=args.mode)
    print(f"compilation target: {spec.to_dict()}")

    report, _ = run_flow(cfg, log_every=0 if args.quick else 100,
                         device=args.device)
    print(report.summary())

    assert report.bit_identical, \
        "backends disagree bit-for-bit — conformance bug"
    if cfg.exact:
        assert report.parity, (
            "exact-mode conversion must preserve accuracy exactly: "
            f"logic {report.logic_acc} vs binarized {report.binarized_acc}")
        print("[ok] exact accuracy parity + bit-identical backends")
    else:
        drop = report.binarized_acc - max(report.logic_acc.values())
        print(f"[ok] ISF mode: acc drop {drop:+.4f} "
              "(paper reports <4% drops); backends bit-identical")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
