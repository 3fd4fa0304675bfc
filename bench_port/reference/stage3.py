"""Plain PyTorch reference of the stage-3 depth-enhancement pipeline: the
serving forward, the train step of the main stage and of its x2 SR
fine-tune, with the train-time hole draws, the loss tail and Adam.

It follows the published method (arXiv:2105.12038 section 3 and its
reference code's ``main_model.py`` / ``main_sr_model.py``, whose as-shipped
loss terms and weights it keeps) in float32, with the stock layers of
``nets.py``; the caller turns TF32 off. Depth maps are planar (B, H, W) in
[-1, 1]; images arrive NHWC, as the benchmark feeds them.

A configuration (``configs/<name>.json``) states every number it reads:
the nets' widths, the loss weights, Adam's settings and the hole sampler's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.reference import nets as N

BORDER = -0.97
SERVING_NETS = ("I2D_features", "Image2Depth", "Depth_f", "Task")
TRAINED_NETS = ("Depth_f", "Task")


def build_nets(cfg, names):
    """The nets ``names`` of configuration ``cfg`` (float32, on the current
    default device)."""
    w = cfg["widths"]
    feats = w["ImageDepthf_outf"]
    make = {
        "I2D_features": lambda: N.generator(w["ImageDepthf_type"], 3, feats,
                                            w["ImageDepthf_basef"]),
        "Image2Depth": lambda: N.generator(w["I2D_type"], feats, 1, w["I2D_base"]),
        "Depth_f": lambda: N.generator(w["Depthf_type"], 2, w["Depthf_outf"], w["Depthf_basef"],
                                       w["Depthf_ndown"]),
        "Task": lambda: N.generator(w["Task_type"], feats + 5 + w["Depthf_outf"], 1,
                                    w["Task_basef"], w["Task_ndown"]),
        "G_A_d": lambda: N.Translator(**cfg["translator"]),
    }
    return {n: make[n]() for n in names}


def param_shapes(cfg, names):
    """{net: {state_dict key: shape}} of the nets ``names``, built on ``meta``."""
    with torch.device("meta"):
        nets = build_nets(cfg, names)
    return {n: {k: tuple(v.shape) for k, v in net.state_dict().items()} for n, net in nets.items()}


def nchw(x):
    return x.permute(0, 3, 1, 2)


def resize(x, hw, mode="bicubic"):
    """A (B, H, W) or (B, C, H, W) map resized to ``hw``: bicubic (a = -0.75,
    half-pixel centres, no antialias) or nearest (source index floor(i * in /
    out)), in float32."""
    planar = x.dim() == 3
    y = x[:, None] if planar else x
    if tuple(y.shape[-2:]) == tuple(hw):
        return x
    if mode == "nearest":
        rows = (torch.arange(hw[0], dtype=torch.float64) * (y.shape[-2] / hw[0])).floor().long()
        cols = (torch.arange(hw[1], dtype=torch.float64) * (y.shape[-1] / hw[1])).floor().long()
        y = y[..., rows.to(y.device), :][..., cols.to(y.device)]
    else:
        y = F.interpolate(y.float(), size=tuple(hw), mode="bicubic", align_corners=False)
    return y[:, 0] if planar else y


# -- the serving forward ----------------------------------------------------

def guidance(nets, images, lr_hw=None, hr_hw=None):
    """(features, depth prior) of the frozen image nets; with ``lr_hw`` the
    SR stage's: the images bicubic-downsampled to LR, the outputs
    bicubic-upsampled back to ``hr_hw``."""
    if lr_hw is not None:
        images = resize(images, lr_hw)
    feats = nets["I2D_features"](images)
    dbi = nets["Image2Depth"](feats)[:, 0]
    if lr_hw is not None:
        feats, dbi = resize(feats, hr_hw), resize(dbi, hr_hw)
    return feats, dbi


def serve(nets, depth, image, lr_hw=None):
    """The enhanced depth (B, H, W) of (B, H, W, 1) depth and (B, H, W, 3)
    image frames, both in [-1, 1]: the real branch of the eval forward (no
    holes drawn); with ``lr_hw`` the SR stage's on the HR input grid."""
    img = nchw(image)
    hr_hw = tuple(img.shape[-2:])
    feats, dbi = guidance(nets, img, lr_hw, hr_hw)
    pair = torch.stack([depth[..., 0], dbi], dim=1)
    fd = nets["Depth_f"](pair)
    return nets["Task"](torch.cat([feats, fd, pair, img], 1))[:, 0]


# -- masks and the hole sampler -----------------------------------------------

def hole_mask(depth):
    return (depth <= BORDER).float()


def valid_mask(depth):
    """1 where no hole lies in the pixel's 3x3 neighbourhood."""
    return 1.0 - F.max_pool2d(hole_mask(depth)[:, None], 3, stride=1, padding=1)[:, 0]


def random_rect_holes(valid, generator, n_max, n_min, p, min_frac, max_frac):
    """Random rectangle hole masks (0 inside a rectangle on a valid pixel,
    else 1), drawn as the published sampler draws them: per sample a count
    in [n_min, n_max), corners uniform over the grid, sizes in [dim //
    min_frac, dim // max_frac), and one Bernoulli(p) a sample and axis that
    keeps or zeroes all its sizes. The draws are made in this order from
    ``generator``, on the mask's device."""
    b, h, w = valid.shape
    dev = valid.device
    n_rect = n_max - 1 if n_max > n_min else n_min

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    number = randint(n_min, max(n_max, n_min + 1), (b, 1))
    xs = randint(0, w, (b, n_rect))
    ys = randint(0, h, (b, n_rect))
    sx = randint(w // min_frac, max(w // max_frac, w // min_frac + 1), (b, n_rect))
    sy = randint(h // min_frac, max(h // max_frac, h // min_frac + 1), (b, n_rect))
    keep = (torch.rand((b, 2), generator=generator, device=dev) < p).long()
    sx, sy = sx * keep[:, :1], sy * keep[:, 1:]
    active = torch.arange(n_rect, device=dev)[None, :] < number
    yy = torch.arange(h, device=dev)[None, None, :, None]
    xx = torch.arange(w, device=dev)[None, None, None, :]
    mask = torch.ones_like(valid)
    for r in range(n_rect):
        inside = ((yy >= ys[:, r, None, None, None]) & (yy < (ys + sy)[:, r, None, None, None])
                  & (xx >= xs[:, r, None, None, None]) & (xx < (xs + sx)[:, r, None, None, None])
                  & active[:, r, None, None, None])[:, 0]
        mask = torch.where(inside & (valid > 0.05), torch.zeros_like(mask), mask)
    return mask


def punch(depth, mask):
    return torch.where(mask < 0.05, torch.full_like(depth, -1.0), depth)


# -- normals and losses -------------------------------------------------------

def safe_norm(x, dim):
    sq = (x * x).sum(dim=dim, keepdim=True)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def gradient(f, dim):
    """numpy.gradient with unit spacing along ``dim``."""
    f = f.movedim(dim, 0)
    g = torch.cat([(f[1] - f[0])[None], (f[2:] - f[:-2]) / 2.0, (f[-1] - f[-2])[None]], 0)
    return g.movedim(0, dim)


def image_normals(depth):
    """normalize([-d depth / d row, -d depth / d col, 1]), (B, 3, H, W)."""
    n = torch.stack([-gradient(depth, 1), -gradient(depth, 2), torch.ones_like(depth)], 1)
    return n / (safe_norm(n, 1) + 1e-6)


def k_normals(depth, K, crop):
    """Normals of the point cloud that intrinsics K (B, 3, 3) and crop boxes
    (B, 4) = [h0, h1, w0, w1] unproject from [-1, 1] depth."""
    d = (depth + 1.0) / 2.0
    b, h, w = d.shape
    v = crop[:, 0:1] + torch.arange(h, device=d.device, dtype=d.dtype)[None] + 0.5
    u = crop[:, 2:3] + torch.arange(w, device=d.device, dtype=d.dtype)[None] + 0.5
    pix = torch.stack([u[:, None, :].expand(b, h, w), v[:, :, None].expand(b, h, w),
                       torch.ones_like(d)], 1)
    pts = torch.einsum("blk,bkhw->blhw", torch.linalg.inv(K.double()).to(d.dtype), pix)
    pts = pts / pts[:, 2:3] * d[:, None]
    du, dv = gradient(pts, 3), gradient(pts, 2)
    n = torch.stack([dv[:, 1] * du[:, 2] - du[:, 1] * dv[:, 2],
                     dv[:, 2] * du[:, 0] - du[:, 2] * dv[:, 0],
                     dv[:, 0] * du[:, 1] - du[:, 0] * dv[:, 1]], 1)
    return n / torch.clamp(safe_norm(n, 1), min=1e-12)


def tv(x):
    return ((x[..., :, :-1] - x[..., :, 1:]).square().sum()
            + (x[..., :-1, :] - x[..., 1:, :]).square().sum())


def l1(x, y):
    return (x - y).abs().mean()


def mse(x, y):
    return (x - y).square().mean()


def hole_means(pred, target, m1, m2, k3_log=None):
    """(mean |d|, mean |d m2|, 5 mean (d m2)^2) of d = target m1 - pred m1:
    the masked means the program under test sums in one fused pass."""
    if k3_log is not None:
        k3_log.append(pred.numel())
    d = target * m1 - pred * m1
    d2 = d * m2
    return d.abs().mean(), d2.abs().mean(), 5.0 * d2.square().mean()


def smoothness(depth, image, num_scales=3):
    """Image-gradient-weighted smoothness over a bilinear (align corners)
    pyramid of (B, H, W) depth and (B, 3, H, W) image: the i-th scale,
    smallest first, weighted 1 / 2^i."""
    h, w = depth.shape[-2:]
    total = 0.0
    for i in range(num_scales):
        d, im, s = depth, image, num_scales - 1 - i
        if s:
            hw = (h // 2 ** s, w // 2 ** s)
            d = F.interpolate(depth[:, None], size=hw, mode="bilinear", align_corners=True)[:, 0]
            im = F.interpolate(image, size=hw, mode="bilinear", align_corners=True)
        wx = torch.exp(-(im[..., :-1, :] - im[..., 1:, :]).abs().mean(1))
        wy = torch.exp(-(im[..., :, :-1] - im[..., :, 1:]).abs().mean(1))
        total = total + ((d[..., :-1, :] - d[..., 1:, :]) * wx).abs().mean() / 2 ** i
        total = total + ((d[..., :, :-1] - d[..., :, 1:]) * wy).abs().mean() / 2 ** i
    return total


# -- the train step -----------------------------------------------------------

def forward_train(nets, batch, cfg, generator, lr_hw=None):
    """The train forward of both branches: the frozen translator degrades the
    synthetic depth, holes are drawn for the real then the synthetic branch,
    Depth_f and Task predict both (one batch of 2B). With ``lr_hw`` the SR
    stage's grids: the guidance at LR, the prediction at HR and its bicubic
    LR copy."""
    syn_img, real_img = nchw(batch["A_i"]), nchw(batch["B_i"])
    syn_depth, real_depth = batch["A_d"][..., 0], batch["B_d"][..., 0]
    hr_hw = tuple(real_img.shape[-2:])
    real_mask, syn_mask = valid_mask(real_depth), valid_mask(syn_depth)
    holes = cfg["holes"]
    with torch.no_grad():
        syn2real = nets["G_A_d"](nchw(batch["A_d"]), syn_img)[:, 0]
        both_img = torch.cat([syn_img, real_img], 0)
        feats, dbi = guidance(nets, both_img, lr_hw, hr_hw)
    draw = dict(generator=generator, n_max=holes["n_max"], n_min=holes["n_min"],
                min_frac=holes["min_frac"], max_frac=holes["max_frac"])
    gt_real = random_rect_holes(real_mask, p=holes["p_real"], **draw)
    gt_syn = random_rect_holes(syn_mask, p=holes["p_syn"], **draw)
    syn2real_masked = punch(syn2real, gt_syn)
    b = syn_img.shape[0]
    pair = torch.cat([torch.stack([syn2real_masked, dbi[:b]], 1),
                      torch.stack([punch(real_depth, gt_real), dbi[b:]], 1)], 0)
    fd = nets["Depth_f"](pair)
    pred = nets["Task"](torch.cat([feats, fd, pair, both_img], 1))[:, 0]
    f = dict(syn_depth=syn_depth, real_depth=real_depth, syn_mask=syn_mask,
             real_mask=real_mask, real_hole_mask=hole_mask(real_depth),
             gt_real=gt_real, gt_syn=gt_syn, syn2real_masked=syn2real_masked,
             real_image=real_img, dbi_real=dbi[b:], pred_syn=pred[:b], pred_real=pred[b:])
    if lr_hw is not None:
        f["pred_real_hr"] = f["pred_real"]
        f["pred_real"] = resize(f["pred_real_hr"], lr_hw)
    return f


def losses_main(f, batch, cfg, k3_log=None):
    """loss_G of the main stage and its terms."""
    w = cfg["loss"]
    m = {}
    syn_depth, real_depth = f["syn_depth"], f["real_depth"]
    pred_syn, pred_real = f["pred_syn"], f["pred_real"]
    syn_mask, real_mask = f["syn_mask"], f["real_mask"]
    add_holes = ((f["syn2real_masked"] < BORDER) | (f["gt_syn"] < 0.1)).float()
    mask1 = syn_mask[:, None]
    no, np_, nr = (image_normals(d) * 100 for d in (syn_depth, pred_syn, pred_real))
    m["tv_syn_norm_old"] = tv(np_) * 1e-7
    m["tv_real_norm_old"] = tv(nr) * 1e-7
    m["syn_norms_old"] = mse(no * mask1, np_ * mask1)
    n_syn = k_normals(syn_depth, batch["K_A"], batch["crop_A"])
    n_syn_pred = k_normals(pred_syn, batch["K_A"], batch["crop_A"])
    n_real_pred = k_normals(pred_real, batch["K_B"], batch["crop_B"])
    m["tv_syn_norm"] = tv(n_syn_pred) * 1e-7
    m["tv_real_norm"] = tv(n_real_pred) * 1e-7
    m["syn_norms"] = l1(n_syn * mask1, n_syn_pred * mask1)
    mask2 = (syn_mask * add_holes)[:, None]
    m["syn_norms_holes"] = l1(n_syn * mask2, n_syn_pred * mask2)
    m["task_syn"], m["holes_syn"], m["holes_syn_l2"] = hole_means(
        pred_syn, syn_depth, syn_mask, add_holes, k3_log)
    m["task_real_by_depth"] = l1(real_depth * real_mask, pred_real * real_mask)
    m["task_real_by_image"] = l1(f["dbi_real"] * f["real_hole_mask"],
                                 pred_real * f["real_hole_mask"])
    real_add = (f["gt_real"] <= 0.1).float()
    m["holes_real"], _, m["holes_real_l2"] = hole_means(pred_real, real_depth, real_add,
                                                        torch.ones_like(real_add), k3_log)
    m["smooth"] = smoothness(pred_real, f["real_image"])
    loss = (m["task_syn"] * w["w_syn_l1"] + (m["holes_syn"] + m["holes_syn_l2"]) * w["w_syn_holes"]
            + m["task_real_by_depth"] * w["w_real_l1_d"]
            + m["task_real_by_image"] * w["w_real_l1_i"]
            + m["tv_syn_norm"] + m["syn_norms_holes"] * w["w_syn_norm"] * 5
            + m["tv_real_norm"] + m["syn_norms_old"] * w["w_syn_norm"]
            + m["tv_real_norm_old"] + m["tv_syn_norm_old"]
            + (m["holes_real"] + m["holes_real_l2"]) * w["w_real_holes"]
            + m["syn_norms"] * w["w_syn_norm"] + m["smooth"] * w["w_smooth"])
    return loss * w["scale_G"], m


def losses_sr(f, batch, cfg, k3_log=None):
    """loss_G of the SR stage and its terms: the real branch compared at LR,
    the as-shipped terms (the synthetic normals against the HR real ones
    under K_A, an unmasked legacy-normal L1, the real-by-image term anchored
    to the synthetic depth, doubled real TV weights)."""
    w = cfg["loss"]
    lr_hw = tuple(f["pred_real"].shape[-2:])
    m = {}
    syn_depth, syn_mask = f["syn_depth"], f["syn_mask"]
    pred_syn, pred_real, pred_hr = f["pred_syn"], f["pred_real"], f["pred_real_hr"]
    real_mask = resize(f["real_mask"], lr_hw, "nearest")
    real_hole_mask = resize(f["real_hole_mask"], lr_hw, "nearest")
    real_depth = resize(f["real_depth"], lr_hw)
    real_image = resize(f["real_image"], lr_hw)
    add_holes = ((f["syn2real_masked"] < BORDER) | (f["gt_syn"] < 0.1)).float()
    mask1 = syn_mask[:, None]
    no, np_, nr = (image_normals(d) * 100 for d in (syn_depth, pred_syn, pred_hr))
    m["tv_syn_norm_old"] = tv(np_) * 1e-7
    m["tv_real_norm_old"] = tv(nr) * 1e-7
    m["syn_norms_old"] = l1(no, np_)
    n_syn = k_normals(syn_depth, batch["K_A"], batch["crop_A"])
    n_syn_pred = k_normals(pred_syn, batch["K_A"], batch["crop_A"])
    n_real_pred = k_normals(pred_real, batch["K_B"], batch["crop_B"])
    n_real_hr = k_normals(pred_hr, batch["K_A"], batch["crop_A"])
    m["tv_syn_norm"] = tv(n_syn_pred) * 1e-7
    m["tv_real_norm"] = tv(n_real_pred) * 1e-7
    m["syn_norms"] = mse(n_syn * mask1, n_real_hr * mask1)
    mask2 = (syn_mask * add_holes)[:, None]
    m["syn_norms_holes"] = l1(n_syn * mask2, n_syn_pred * mask2)
    m["task_syn"], m["holes_syn"], m["holes_syn_l2"] = hole_means(
        pred_syn, syn_depth, syn_mask, add_holes, k3_log)
    m["task_real_by_depth"] = l1(real_depth * real_mask, pred_real * real_mask)
    syn_lr = resize(syn_depth, lr_hw, "nearest")
    m["task_real_by_image"] = l1(syn_lr * real_hole_mask, pred_real * real_hole_mask)
    real_add = resize((f["gt_real"] <= 0.1).float(), lr_hw, "nearest")
    m["holes_real"], _, m["holes_real_l2"] = hole_means(pred_real, real_depth, real_add,
                                                        torch.ones_like(real_add), k3_log)
    m["smooth"] = smoothness(pred_real, real_image)
    loss = (m["task_syn"] * w["w_syn_l1"] + (m["holes_syn"] + m["holes_syn_l2"]) * w["w_syn_holes"]
            + m["task_real_by_depth"] * w["w_real_l1_d"]
            + m["task_real_by_image"] * w["w_real_l1_i"]
            + m["tv_syn_norm"] + m["syn_norms_holes"] * w["w_syn_norm"] * 5
            + m["tv_real_norm"] * 2 + m["syn_norms_old"] * w["w_syn_norm"] * 5
            + m["tv_real_norm_old"] * 2 + m["tv_syn_norm_old"]
            + (m["holes_real"] + m["holes_real_l2"]) * w["w_real_holes"]
            + m["syn_norms"] * w["w_syn_norm"] + m["smooth"] * w["w_smooth"])
    return loss * w["scale_G"], m


class Adam:
    """Adam with bias-corrected moments and no weight decay:
    p -= lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params, lr, betas, eps):
        self.params, self.lr, self.betas, self.eps = list(params), lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def train_step(nets, batch, cfg, generator, optimizer, lr_hw=None, k3_log=None):
    """One step: forward, loss_G, backward, Adam on Depth_f and Task; with
    ``lr_hw`` the SR stage's. Returns (loss, the trained leaves' gradients in
    ``optimizer.params``' order, Task's prediction (2B, H, W): the synthetic
    branch's frames, then the real's)."""
    for p in optimizer.params:
        p.grad = None
    f = forward_train(nets, batch, cfg, generator, lr_hw)
    loss, _ = (losses_sr if lr_hw is not None else losses_main)(f, batch, cfg, k3_log)
    loss.backward()
    grads = [p.grad.detach().clone() for p in optimizer.params]
    optimizer.step()
    pred = torch.cat([f["pred_syn"], f.get("pred_real_hr", f["pred_real"])]).detach()
    return loss.detach(), grads, pred
