"""Coordinate transforms and stream-aligned frames."""
from .transforms import convert_coords, convert_vectors, convert_to_vel_los
from .streams import (
    generate_stream_coords,
    to_stream_coords,
    get_observed_stream_coords,
)

__all__ = [
    "convert_coords",
    "convert_vectors",
    "convert_to_vel_los",
    "generate_stream_coords",
    "to_stream_coords",
    "get_observed_stream_coords",
]
