"""The paper's own model/system config: in-house DPA-1 (1.6 M params) +
GROMACS-DeePMD coupling parameters (paper Tab. II / Sec. IV-B)."""
from ..dp.model import DPConfig, paper_dpa1_config


# MD-run cutoff r_c = 0.8 nm (Tab. II), se_attention_v2, emb (32, 64, 128),
# 3 attention layers x 256, fitting 3 x 256.  ``dtype`` selects the
# inference precision policy ("float32" = the paper's FP32 runs;
# "bfloat16" = bf16 matmul operands with fp32 accumulation).
def paper_config(ntypes: int = 4, sel: int = 64,
                 dtype: str = "float32") -> DPConfig:
    return paper_dpa1_config(ntypes=ntypes, rcut=0.8, sel=sel, dtype=dtype)


MD_PARAMS = {
    "dt_fs": 2.0,
    "md_steps_small": 10_000,   # 1YRF validation run
    "md_steps_large": 200,      # 1HCI benchmark run
    "nvt_npt_steps": 40_000,
    "rc_classical": 1.2,
    "rc_dp": 0.8,
    "dp_group": "protein",
}
