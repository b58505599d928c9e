from .checkpoint import (AsyncCheckpointer, CheckpointCorrupt,  # noqa: F401
                         latest_step_dir, load_pytree, save_pytree)
