"""ssm_f32_ms.train: device ms a step of the kernels launched under the
program's ssm.f32 ranges (the Mamba-2 block's f32 chains: softplus, conv
and SiLU; D skip, gate and RMS norm), in the forward and in the block
remat's recompute; the chains' own autograd backward is not under them."""
from cellbench import program

TAGS = ("ssm.f32",)


def read(tc):
    return program.tagged_ms_per(tc, "ssm.f32", tc.counts["steps"])
