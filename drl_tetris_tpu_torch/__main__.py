"""``python -m drl_tetris_tpu_torch``: the port's command line (cli/main.py)."""
import sys
import types

from drl_tetris_tpu_torch.cli.main import main

if __name__ == "__main__":
    # The program's MetricsWriter writes TensorBoard's event files without
    # TensorFlow: marked as TensorBoard's notf build, its lazy ``tf`` is the
    # bundled stub, so a run does not import TensorFlow (about 14 s of a
    # process's start-up).  Set here, for this process only, and not in a
    # library module that other code in the same process imports.
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    main()
