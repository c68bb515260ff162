"""``python -m tpu_knn_torch``: the experiment CLI (cli.py)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
