"""python -m mr_mt3_tpu_torch.train: the train CLI (see __init__.py)."""

from mr_mt3_tpu_torch.train import main

if __name__ == '__main__':
    main()
