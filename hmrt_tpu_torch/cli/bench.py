"""CLI: run the B1-B5 benchmark configs, one JSON row each.

    python -m hmrt_tpu_torch.cli.bench B1 B2 B3 B4 B5 [--floor] [--out f] [--cpu]
"""

from hmrt_tpu_torch.bench.runner import main

if __name__ == "__main__":
    main()
