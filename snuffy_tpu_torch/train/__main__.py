"""`python -m snuffy_tpu_torch.train ...`: the MIL training CLI
(`train/cli.py`)."""

from snuffy_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
