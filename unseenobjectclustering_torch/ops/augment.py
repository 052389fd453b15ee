"""Image augmentation on the device: HLS chromatic jitter and
Gaussian / motion-blur noise.

Port of ``unseenobjectclustering_tpu/ops/augment.py`` (reference
lib/utils/blob.py:74-129, :141-192).  HLS follows OpenCV's conventions (hue
in [0, 180), lightness and saturation in [0, 255]).

Each op is two parts: a *draw* of its random numbers from an explicit
``torch.Generator`` (one row per image), and an *apply* that is a
deterministic function of the image and the draws.  The draws are the JAX
package's raw samples (standard uniforms, standard normals, integer
indices) and the apply does the JAX package's arithmetic on them, so
draws taken from a JAX key give the JAX function's output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLUR_SIZES = (3, 5, 7, 9, 11, 15)
BLUR_KMAX = 15


def _uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device)


def _bgr_to_hls(bgr: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BGR [0,255] float -> (H [0,180), L [0,255], S [0,255]); OpenCV HLS."""
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    vsum = maxc + minc
    vdiff = maxc - minc
    l = vsum / 2.0
    pos = vdiff > 0
    safe_diff = torch.where(pos, vdiff, torch.ones_like(vdiff))
    s = torch.where(
        l < 127.5, 255.0 * vdiff / torch.clamp(vsum, min=1e-6),
        255.0 * vdiff / torch.clamp(510.0 - vsum, min=1e-6))
    s = torch.where(pos, s, torch.zeros_like(s))
    rc = (maxc - r) / safe_diff
    gc = (maxc - g) / safe_diff
    bc = (maxc - b) / safe_diff
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h * 30.0, 180.0)
    h = torch.where(pos, h, torch.zeros_like(h))
    return h, l, s


def _hls_to_bgr(h: torch.Tensor, l: torch.Tensor, s: torch.Tensor
                ) -> torch.Tensor:
    """(H [0,180), L, S [0,255]) -> BGR [0,255] float."""
    hn = h * 2.0 / 360.0
    ln = l / 255.0
    sn = s / 255.0
    m2 = torch.where(ln <= 0.5, ln * (1.0 + sn), ln + sn - ln * sn)
    m1 = 2.0 * ln - m2

    def channel(hue):
        hue = torch.remainder(hue, 1.0)
        return torch.where(
            hue < 1.0 / 6.0, m1 + (m2 - m1) * hue * 6.0,
            torch.where(hue < 0.5, m2,
                        torch.where(hue < 2.0 / 3.0,
                                    m1 + (m2 - m1) * (2.0 / 3.0 - hue) * 6.0,
                                    m1)))

    r = channel(hn + 1.0 / 3.0)
    g = channel(hn)
    b = channel(hn - 1.0 / 3.0)
    return torch.stack([b, g, r], dim=-1) * 255.0


def draw_chromatic(gen: torch.Generator, batch: int, device) -> torch.Tensor:
    """[B, 3] standard uniforms: hue, lightness and saturation shifts."""
    return _uniform(gen, (batch, 3), device)


def chromatic_transform_device(bgr: torch.Tensor, u: torch.Tensor
                               ) -> torch.Tensor:
    """HLS jitter (blob.py:74-99): hue +-9 of 180, lightness and saturation
    +-25.6 of 255.  bgr [B, H, W, 3] in 0..255, u [B, 3] from
    draw_chromatic.  Returns float32 BGR in 0..255."""
    u = u.to(torch.float32)[:, None, None, :]
    d_h = (u[..., 0] - 0.5) * 0.1 * 180.0
    d_l = (u[..., 1] - 0.5) * 0.2 * 256.0
    d_s = (u[..., 2] - 0.5) * 0.2 * 256.0
    h, l, s = _bgr_to_hls(bgr.to(torch.float32))
    h = torch.remainder(h + d_h, 180.0)
    l = torch.clamp(l + d_l, 0.0, 255.0)
    s = torch.clamp(s + d_s, 0.0, 255.0)
    return torch.clamp(_hls_to_bgr(h, l, s), 0.0, 255.0)


def draw_noise(gen: torch.Generator, batch: int, height: int, width: int,
               device) -> dict[str, torch.Tensor]:
    """The draws of add_noise_device for B images: the Gaussian-or-blur
    coin, the noise level and sigma, the [H, W, 1] normal field, the blur
    size's index into BLUR_SIZES and the direction coin."""
    return {"select": _uniform(gen, (batch,), device),
            "level": _uniform(gen, (batch,), device),
            "sigma": _uniform(gen, (batch,), device),
            "normal": torch.randn((batch, height, width, 1), generator=gen,
                                  device=device),
            "size": torch.randint(0, len(BLUR_SIZES), (batch,),
                                  generator=gen, device=device),
            "horizontal": _uniform(gen, (batch,), device)}


def _blur_kernels(size_idx: torch.Tensor, horizontal: torch.Tensor
                  ) -> torch.Tensor:
    """[B, 15, 15] line kernels: `size` taps centred on the middle row
    (horizontal) or column, normalized to sum 1."""
    dev = size_idx.device
    sizes = torch.tensor(BLUR_SIZES, device=dev)[size_idx]
    idx = torch.arange(BLUR_KMAX, device=dev)
    on = ((idx[None] - BLUR_KMAX // 2).abs()
          <= ((sizes - 1) // 2)[:, None]).to(torch.float32)      # [B, 15]
    k = torch.zeros((size_idx.shape[0], BLUR_KMAX, BLUR_KMAX),
                    dtype=torch.float32, device=dev)
    row = torch.zeros_like(k)
    row[:, BLUR_KMAX // 2, :] = on
    col = torch.zeros_like(k)
    col[:, :, BLUR_KMAX // 2] = on
    k = torch.where(horizontal[:, None, None], row, col)
    return k / torch.clamp(k.sum(dim=(1, 2), keepdim=True), min=1.0)


def add_noise_device(image: torch.Tensor, draws: dict[str, torch.Tensor],
                     level: float = 0.1) -> torch.Tensor:
    """90% Gaussian / 10% motion blur (blob.py:102-129), per image.
    image [B, H, W, 3] in 0..255.  The motion blur is a zero-padded "SAME"
    15x15 line convolution."""
    img = image.to(torch.float32)
    b, h, w, c = img.shape
    noise_level = draws["level"] * level
    sigma = draws["sigma"] * noise_level * 256.0
    gauss = sigma[:, None, None, None] * draws["normal"]
    gaussian = torch.clamp(img + gauss, 0.0, 255.0)

    kernels = _blur_kernels(draws["size"], draws["horizontal"] < 0.5)
    weight = kernels.repeat_interleave(c, dim=0)[:, None]    # [B*C, 1, 15, 15]
    x = img.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    blurred = F.conv2d(x, weight, padding=BLUR_KMAX // 2, groups=b * c)
    blurred = blurred.reshape(b, c, h, w).permute(0, 2, 3, 1)
    use_gauss = (draws["select"] < 0.9)[:, None, None, None]
    return torch.where(use_gauss, gaussian, blurred)
