"""Resolution math and image metrics (``nmf_tpu/utils.py``), numpy only."""
import numpy as np


def n_to_reso(n_voxels, aabb):
    """Voxel count -> per-axis resolution."""
    xyz_min, xyz_max = np.asarray(aabb[0]), np.asarray(aabb[1])
    voxel_size = ((xyz_max - xyz_min).prod() / n_voxels) ** (1 / 3)
    # small epsilon absorbs float error so exact cube counts stay exact
    return [int(v + 1e-4) for v in ((xyz_max - xyz_min) / voxel_size)]


def psnr_from_mse(mse):
    return -10.0 * np.log(mse) / np.log(10.0)


def rgb_psnr(img0, img1, quantize=True):
    """PSNR with 8-bit quantization of both images."""
    img0 = np.asarray(img0)
    img1 = np.asarray(img1)
    if quantize:
        img0 = (np.clip(img0, 0, 1) * 255).astype(np.uint8).astype(
            np.float64) / 255
        img1 = (np.clip(img1, 0, 1) * 255).astype(np.uint8).astype(
            np.float64) / 255
    return psnr_from_mse(np.mean((img0 - img1) ** 2))


def _filter_valid(z, filt, axis):
    """'valid' correlation of z with the 1D filter along ``axis``."""
    win = np.lib.stride_tricks.sliding_window_view(z, len(filt), axis=axis)
    return win @ filt


def rgb_ssim(img0, img1, max_val=1.0, filter_size=11, filter_sigma=1.5,
             k1=0.01, k2=0.03):
    """mip-NeRF Gaussian-filter SSIM of two (H, W, 3) images. The filter is
    symmetric, so its 'valid' correlation equals the convolution."""
    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)
    if img0.ndim != 3 or img0.shape[-1] != 3 or img0.shape != img1.shape:
        raise ValueError(f"rgb_ssim: expected two (H, W, 3) images, got "
                         f"{img0.shape} and {img1.shape}")
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)

    def filt_fn(z):
        return _filter_valid(_filter_valid(z, filt, 0), filt, 1)

    mu0 = filt_fn(img0)
    mu1 = filt_fn(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = np.maximum(0.0, filt_fn(img0 ** 2) - mu00)
    sigma11 = np.maximum(0.0, filt_fn(img1 ** 2) - mu11)
    sigma01 = filt_fn(img0 * img1) - mu01
    sigma01 = np.sign(sigma01) * np.minimum(np.sqrt(sigma00 * sigma11),
                                            np.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return float(np.mean(numer / denom))
