"""Core library of the port: hardware records, slice profiles, offload plans.

- hw: chip / pod / host records of the *modelled* hardware families the
  planner and later the scheduler price (not the card the port runs on)
- slices: static slice profiles
- offload: fine-grained host-offload planner and its placement on two tiers
"""
from repro_torch.core.hw import V5E, V5E_POD, ChipSpec, PodSpec
from repro_torch.core.offload import OffloadPlan, TensorInfo, plan_offload
from repro_torch.core.slices import PROFILES, SliceProfile, get_profile, profile_table

__all__ = [
    "V5E", "V5E_POD", "ChipSpec", "PodSpec",
    "OffloadPlan", "TensorInfo", "plan_offload",
    "PROFILES", "SliceProfile", "get_profile", "profile_table",
]
