"""``python -m drl_tetris_tpu_torch``: the port's command line (cli/main.py)."""
from drl_tetris_tpu_torch.cli.main import main

if __name__ == "__main__":
    main()
