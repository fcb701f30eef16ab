"""The command line of the PyTorch port: ``python main_torch.py --help``.

    python main_torch.py --algo dijkstra --scenario Easy --mode eval \\
        --start-end-time 21600 28800 --timestep_size 2 --device cpu

runs on the CUDA card by default (``--device cuda``).
"""
from tarl_tpu_torch.runner import main

if __name__ == "__main__":
    main()
