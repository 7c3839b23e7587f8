"""Batched-serving example on the PyTorch port: prefill + synchronous
batched decode over a request queue for a reduced Mixtral (MoE +
sliding-window attention), its MoE layers through the gather dispatch,
which runs the moe_gmm kernel.

    PYTHONPATH=src python examples/serve_batched_torch.py               # GPU
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu  # CPU

Without a GPU and without ``--device cpu`` it raises.  Any other argument
goes to ``repro_torch.launch.serve`` as it is.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    from repro_torch.launch.serve import main as serve_main
    return serve_main(["--arch", "mixtral-8x7b", "--smoke",
                       "--moe-dispatch", "gather",
                       "--requests", "8", "--slots", "4",
                       "--prompt-len", "32", "--gen", "16"]
                      + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
