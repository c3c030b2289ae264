from .adamw import (OptState, adamw_init, adamw_init_spec, adamw_update,
                    clip_by_global_norm)
from .schedule import cosine_schedule, linear_warmup_cosine
from .compression import (compress_topk_int8, decompress_topk_int8,
                          error_feedback_update)
