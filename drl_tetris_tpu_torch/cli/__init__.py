"""Command-line interface of the port (``python -m drl_tetris_tpu_torch``)."""
