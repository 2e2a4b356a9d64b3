"""Core types: parameter schemas, colorspace math, .cube LUT handling."""

from .colorspace import (lab_to_rgb, linear_to_srgb, rec709_luma, rgb_to_lab,
                         srgb_to_linear)
from .cube import (GLOBAL_LUT_CACHE, CubeParseError, LutCache, LutData,
                   build_palette_lut, identity_lut, list_lut_files,
                   parse_color_list, parse_cube, parse_hex_color, write_cube)
from .params import (AdjustSettings, ColorMatchParams, EnhancerSettings,
                     GrainParams, LUTParams, SharpenParams, auto_batch_size,
                     output_dimensions, round_dimension)

__all__ = [
    "lab_to_rgb", "linear_to_srgb", "rec709_luma", "rgb_to_lab",
    "srgb_to_linear", "GLOBAL_LUT_CACHE", "CubeParseError", "LutCache",
    "LutData", "build_palette_lut", "identity_lut", "list_lut_files",
    "parse_color_list", "parse_cube", "parse_hex_color", "write_cube",
    "AdjustSettings", "ColorMatchParams", "EnhancerSettings", "GrainParams",
    "LUTParams", "SharpenParams", "auto_batch_size", "output_dimensions",
    "round_dimension",
]
