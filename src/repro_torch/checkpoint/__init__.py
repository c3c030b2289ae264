from .store import (AsyncCheckpointer, CheckpointManager, latest_step,
                    restore, save)
