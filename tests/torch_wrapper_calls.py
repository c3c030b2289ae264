"""Calls of the port's CUDA kernel wrappers (the six kernels and the
split norm's two entries) on small inputs whose
floating-point tensors require grad (the weights of a model in training),
shared by the CPU tests (tests/test_torch_kernels.py) and the card tests
(tests/test_torch_cuda.py).  Imports no JAX."""
import torch

WRAPPERS = ["flash_attention", "flash_decode", "mamba_scan", "moe_gmm",
            "rmsnorm", "rmsnorm_sumsq", "rmsnorm_scaled", "slstm_seq"]


def wrapper_call(name, dev):
    """A call of the ``name`` kernel wrapper on ``dev``, as a function of
    nothing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import slstm_cell as sl
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g).to(dev).requires_grad_()
    calls = {
        "flash_attention": lambda: fa.flash_attention_fwd(
            t(1, 2, 64, 16), t(1, 2, 64, 16), t(1, 2, 64, 16)),
        "flash_decode": lambda: fd.flash_decode(
            t(1, 2, 16), t(1, 2, 128, 16), t(1, 2, 128, 16),
            torch.full((1,), 100, dtype=torch.int32, device=dev)),
        "mamba_scan": lambda: ms.mamba_scan(
            t(1, 16, 2, 8), t(1, 16, 2), t(2), t(1, 16, 4), t(1, 16, 4),
            chunk=16),
        "moe_gmm": lambda: mg.moe_gmm(t(2, 4, 32), t(2, 32, 64)),
        "rmsnorm": lambda: rn.rmsnorm(t(4, 64), t(64)),
        "rmsnorm_sumsq": lambda: rn.sumsq(t(4, 64)),
        "rmsnorm_scaled": lambda: rn.scaled(t(4, 64), t(4), t(64), 256),
        "slstm_seq": lambda: sl.slstm_seq(t(1, 4, 4, 2, 8), t(4, 2, 8, 8),
                                          t(4, 2, 8)),
    }
    return calls[name]
