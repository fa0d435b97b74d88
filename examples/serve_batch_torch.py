"""Batched serving example on the PyTorch port (the counterpart of
``examples/serve_batch.py``): greedy decode on three different architecture
families (dense GQA, SSM, MoE) through the same serve_step API, each by
``python -m repro_torch.launch.serve --smoke``'s ``main``.

    PYTHONPATH=src python examples/serve_batch_torch.py [--device cuda|cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises when no CUDA
device is there.  ``main(argv)`` returns {arch: greedy tokens [B, gen]}.
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.launch import serve

ARCHS = ("qwen3_1_7b", "mamba2_130m", "mixtral_8x22b")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", nargs="+", default=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the GPU, raising without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    out = {}
    for arch in args.archs:
        print(f"=== {arch} ===")
        out[arch] = serve.main(["--arch", arch, "--smoke", "--batch", str(args.batch),
                                "--prompt-len", str(args.prompt_len), "--gen", str(args.gen),
                                "--device", dev.type])
    return out


if __name__ == "__main__":
    main()
