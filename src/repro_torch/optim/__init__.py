from .adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from .schedule import ScheduleConfig, lr_at

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "ScheduleConfig", "lr_at"]
