"""Operations and bytes of the BigGAN-deep generator (Brock et al.,
arXiv:1809.11096, App. B; ``pytorch_pretrained_biggan``'s layout) and of its
SAGAN attention block alone, counted from shapes.

Every convolution, linear map and matrix product counts as a direct one:
two operations a multiply-add.  A block's convs are 1x1 at its input side,
3x3 (both) and 1x1 at its output side; each conditional batch norm maps the
conditioning vector to a gain and an offset.  The attention block: three 1x1
convs to theta, phi and g, the logits theta^T phi over the pooled positions,
the weighted sum g beta^T and the output 1x1 conv.  Batch norms, ReLUs,
upsampling, pools, the softmax, tanh and the skip adds are elementwise and
are not counted.  The backward to the latent repeats every conv and linear
map once (its input gradient; the weights get no gradient) and each of the
attention's two products twice (both of its operands depend on the input).
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def _layers(cfg: dict) -> List[Tuple[bool, int, int]]:
    return [(bool(up), int(i), int(o)) for up, i, o in cfg["layers"]]


def attention_shape(cfg: dict) -> Tuple[int, int]:
    """(channels, side) at the attention block."""
    side = 4
    layers = _layers(cfg)
    for up, _, _ in layers[:cfg["attention_layer_position"]]:
        side *= 2 if up else 1
    pre = layers[:cfg["attention_layer_position"]]
    return (pre[-1][2] if pre else 16) * cfg["channel_width"], side


def attention_flops(cfg: dict) -> Dict[str, float]:
    """One image's attention forward, by kind: ``conv`` (the four 1x1 convs)
    and ``product`` (the logits and the weighted sum)."""
    c, side = attention_shape(cfg)
    hw = side * side
    conv = 2.0 * hw * (c * c // 8 * 2 + c * c // 2) + 2.0 * hw * (c // 2) * c
    product = 2.0 * hw * (hw // 4) * (c // 8) + 2.0 * (c // 2) * (hw // 4) * hw
    return {"conv": conv, "product": product}


def forward_flops(cfg: dict) -> Dict[str, float]:
    """One image's generator forward, by kind: ``embed`` (the class
    embedding, whose one-hot input takes no gradient), ``conv`` (the blocks'
    and the output conv), ``linear`` (gen_z and the batch norms' gains and
    offsets) and the attention's ``attn_conv`` / ``attn_product``."""
    ch = cfg["channel_width"]
    cd = cfg["z_dim"] + cfg["class_embed_dim"]
    linear = 2.0 * cd * 16 * 16 * ch
    conv, side = 0.0, 4
    for up, in_m, out_m in _layers(cfg):
        cin, cout = in_m * ch, out_m * ch
        mid = cin // 4
        out_side = side * 2 if up else side
        conv += 2.0 * cin * mid * side * side  # 1x1 reduce
        conv += 2 * 2.0 * 9 * mid * mid * out_side * out_side  # the two 3x3
        conv += 2.0 * mid * cout * out_side * out_side  # 1x1 expand
        linear += 2 * 2.0 * cd * (cin + 3 * mid)  # the four batch norms' gains and offsets
        side = out_side
    conv += 2.0 * 9 * _layers(cfg)[-1][2] * ch * 3 * side * side  # output conv
    a = attention_flops(cfg)
    return {"embed": 2.0 * cfg["num_classes"] * cfg["class_embed_dim"], "conv": conv, "linear": linear,
            "attn_conv": a["conv"], "attn_product": a["product"]}


def n_params(cfg: dict) -> int:
    """Elements of the generator's weights at the truncation in use (one
    row of each batch norm's statistics, not the stored ``n_stats``)."""
    ch = cfg["channel_width"]
    cd = cfg["z_dim"] + cfg["class_embed_dim"]
    total = cfg["num_classes"] * cfg["class_embed_dim"] + (cd + 1) * 16 * 16 * ch
    for _, in_m, out_m in _layers(cfg):
        cin, cout = in_m * ch, out_m * ch
        mid = cin // 4
        total += (cin + 1) * mid + 2 * (9 * mid + 1) * mid + (mid + 1) * cout
        total += (cin + 3 * mid) * (2 * cd + 2)  # gains, offsets, a mean and a variance
    c, _ = attention_shape(cfg)
    total += c * c // 8 * 2 + c * c // 2 + c // 2 * c + 1
    out = _layers(cfg)[-1][2] * ch
    return total + 4 * out + 9 * out * 3 + 3


def generator(cfg: dict, batch: int, dtype: str, backward: bool) -> Dict[str, float]:
    """Operations and boundary bytes of the generator at ``batch`` images,
    forward or forward + backward to z: z in, the image out, the float32
    weights read once; with the backward the image's cotangent in and z's
    gradient out as well."""
    f = forward_flops(cfg)
    flops = batch * (sum(f.values()) + ((sum(f.values()) - f["embed"] + f["attn_product"]) if backward else 0.0))
    esz = 4 if dtype == "float32" else 2
    img = batch * cfg["img_size"] ** 2 * 3
    nbytes = 4.0 * n_params(cfg) + esz * (batch * cfg["z_dim"] + img) * (2 if backward else 1)
    return {"flops": flops, "bytes": nbytes}


def attention(cfg: dict, batch: int, dtype: str, backward: bool) -> Dict[str, float]:
    """Operations and boundary bytes of the attention block alone at
    ``batch`` images: x in, the output out, the float32 weights read once;
    with the backward the output's cotangent in and x's gradient out."""
    a = attention_flops(cfg)
    flops = batch * ((a["conv"] + a["product"]) * (2 if backward else 1) + (a["product"] if backward else 0.0))
    c, side = attention_shape(cfg)
    esz = 4 if dtype == "float32" else 2
    act = batch * c * side * side
    weights = c * c // 8 * 2 + c * c // 2 + c // 2 * c + 1
    return {"flops": flops, "bytes": 4.0 * weights + esz * act * (2 if backward else 1) * 2}
