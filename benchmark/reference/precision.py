"""The control: the reference computed in the precision below the one a
configuration states.

For a bfloat16 network that is float8 (e4m3): every convolution's weights
and input are rounded to float8 and back.  The bundle adjustment, in
float32 with TF32 off, gets TF32: every matrix product's operands rounded
to TF32's 10-bit mantissa (`tf32_products`), as a TF32 product reads
them, whether or not the library would route that product to TF32.  For
a float32 network with TF32 off it is TF32: matrix products and
convolutions in TF32.
"""

import contextlib

import torch

F8 = torch.float8_e4m3fn
F8_MAX = 448.0
TF32_DROP = 13        # float32's 23 mantissa bits less TF32's 10


def round_f8(x):
    """Round to float8 e4m3 (saturating) and back to x's dtype."""
    return x.clamp(-F8_MAX, F8_MAX).to(F8).to(x.dtype)


def to_float8(net):
    """Round `net`'s convolution weights to float8 in place and round every
    convolution's input on the way in; returns the hook handles."""
    handles = []
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(round_f8(m.weight))
                handles.append(m.register_forward_pre_hook(
                    lambda mod, args: (round_f8(args[0]),) + args[1:]))
    return handles


@contextlib.contextmanager
def tf32(on):
    """TF32 matrix products and convolutions on (`on`) or off inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(x):
    """Round float32 `x` to TF32's 10-bit mantissa (to nearest, ties
    away from zero), kept in float32."""
    bits = x.float().contiguous().view(torch.int32)
    half = 1 << (TF32_DROP - 1)
    mask = ~((1 << TF32_DROP) - 1)
    return ((bits + half) & mask).view(torch.float32)


@contextlib.contextmanager
def tf32_products():
    """Inside, the reference bundle adjustment's matrix products read
    their operands in TF32."""
    from . import dba

    old = dba.OPERAND
    dba.OPERAND = round_tf32
    try:
        yield
    finally:
        dba.OPERAND = old
