"""Perspective (homography) warp on tensors: the crop of a text quad to a
fixed patch, and the paste-back of a patch onto a canvas.

Equivalent to ``cv2.getPerspectiveTransform`` + ``cv2.warpPerspective``
(INTER_LINEAR) as the reference uses them: BORDER_REPLICATE on the crop,
BORDER_TRANSPARENT on the paste-back. Points are (x, y) pixel coordinates;
quads list top-left, top-right, bottom-right, bottom-left. Images are
(..., H, W, C) channel-last, the JAX package's layout.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _rect_pts(w: int, h: int, device) -> torch.Tensor:
    return torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0],
                         [0.0, h - 1.0]], dtype=torch.float32, device=device)


def solve_homography(src_pts: torch.Tensor,
                     dst_pts: torch.Tensor) -> torch.Tensor:
    """3x3 homographies mapping src_pts -> dst_pts, (..., 4, 2) each, as
    ``cv2.getPerspectiveTransform(src, dst)``; batched over leading dims."""
    src_pts, dst_pts = torch.broadcast_tensors(src_pts, dst_pts)
    x, y = src_pts[..., 0], src_pts[..., 1]          # (..., 4)
    u, v = dst_pts[..., 0], dst_pts[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    row_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y],
                        dim=-1)                       # (..., 4, 8)
    row_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y],
                        dim=-1)
    a = torch.cat([row_u, row_v], dim=-2)             # (..., 8, 8)
    rhs = torch.cat([u, v], dim=-1)[..., None]        # (..., 8, 1)
    p = torch.linalg.solve(a, rhs)[..., 0]            # (..., 8)
    m = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _apply_homography(m: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """m (..., 3, 3) applied to points (H, W, 2) -> (..., H, W, 2)."""
    x, y = xy[..., 0], xy[..., 1]
    m = m[..., None, None, :, :]                      # broadcast over H, W
    denom = m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2]
    u = (m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2]) / denom
    v = (m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2]) / denom
    return torch.stack([u, v], dim=-1)


def _bilinear_sample(image: torch.Tensor,
                     uv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample an (H, W, C) image at float (..., 2) coordinates, clamped into
    the image (BORDER_REPLICATE). Returns the samples (..., C) and the
    in-bounds mask (...,) for BORDER_TRANSPARENT compositing."""
    h, w = image.shape[0], image.shape[1]
    u, v = uv[..., 0], uv[..., 1]
    in_bounds = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    u = u.clamp(0.0, w - 1.0)
    v = v.clamp(0.0, h - 1.0)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    img = image.float()
    top = img[y0, x0] * (1.0 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1.0 - fx) + img[y1, x1] * fx
    return top * (1.0 - fy) + bot * fy, in_bounds


def _pixel_grid(h: int, w: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)              # (h, w, 2) as (x, y)


def perspective_crop_batch(images: torch.Tensor, quads: torch.Tensor,
                           out_h: int, out_w: int) -> torch.Tensor:
    """Warp each image's quad into an (out_h, out_w) patch.

    images (B, H, W, C) uint8 or float; quads (B, 4, 2). Returns
    (B, out_h, out_w, C) float32, scaled to [0, 1] if the input was uint8.
    Each output pixel samples the source at the inverse map (rect -> quad).
    """
    rect = _rect_pts(out_w, out_h, images.device)
    m_inv = solve_homography(rect, quads.float())     # (B, 3, 3)
    uv = _apply_homography(m_inv, _pixel_grid(out_h, out_w, images.device))
    out = torch.stack([_bilinear_sample(img, uv_i)[0]
                       for img, uv_i in zip(images, uv)])
    if images.dtype == torch.uint8:
        out = out / 255.0
    return out


def perspective_unwarp(patch: torch.Tensor, quad: torch.Tensor,
                       canvas: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    """Paste a (h, w, C) patch onto an (out_h, out_w, C) canvas at ``quad``
    (4, 2); canvas pixels outside the warped patch are left untouched
    (BORDER_TRANSPARENT)."""
    h, w = patch.shape[0], patch.shape[1]
    m = solve_homography(quad.float(), _rect_pts(w, h, patch.device))
    uv = _apply_homography(m, _pixel_grid(out_h, out_w, patch.device))
    sampled, inside = _bilinear_sample(patch, uv)
    out = torch.where(inside[..., None], sampled, canvas.float())
    if canvas.dtype == torch.uint8:
        return out.clamp(0, 255).to(torch.uint8)
    return out.to(canvas.dtype)
