"""Helpers of the port: the run harness, logging, statistics, TensorBoard
events, layer tables and host-side image and file helpers (``misc``), and
the uint8 conversion of the generate-images path below."""

import torch


def generator_output_to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW generator output -> uint8 NHWC, on the images' device:
    ``clip((x + 1) * 127.5 + 0.5, 0, 255)`` truncated, the conversion of the
    generate-images CLI."""
    img = ((images + 1.0) * 127.5 + 0.5).clamp(0, 255).to(torch.uint8)
    return img.permute(0, 2, 3, 1)
