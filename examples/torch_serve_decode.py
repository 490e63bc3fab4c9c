"""Batched serving example on the PyTorch port: prefill + greedy decode
over request batches, with the per-layer recurrent state of Mamba-2's SSD
blocks carried from prefill into decode. The counterpart of
``examples/serve_decode.py``, with the same arguments.

Run on the card:  PYTHONPATH=src python examples/torch_serve_decode.py
Run on the CPU:   PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
"""
import sys

from repro_torch.launch import serve


def main():
    argv = ["--arch", "mamba2-2.7b", "--smoke", "--requests", "8",
            "--batch", "4", "--prompt-len", "24", "--gen", "16"]
    # pass through any user overrides (e.g. --engine fixed --device cpu)
    argv.extend(sys.argv[1:])
    return serve.main(argv)


if __name__ == "__main__":
    main()
