"""Device discovery for the serving plane (the multi-GPU programs of the
reference's ``parallel/`` come with the multi-GPU slice)."""

from .devices import resolve_lane_devices

__all__ = ["resolve_lane_devices"]
