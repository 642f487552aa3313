"""``python -m neighbour_feature_pooling_tpu_torch``: the experiment CLI."""

from .cli import main

if __name__ == "__main__":
    main()
