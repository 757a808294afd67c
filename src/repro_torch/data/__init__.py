from .regression import (PAPER_DATASETS, PAPER_DATASETS_FULL, SyntheticSpec,
                         lam_for, make_regression)
from .tokens import TokenStream, synthetic_lm_batch

__all__ = ["SyntheticSpec", "make_regression", "lam_for", "PAPER_DATASETS",
           "PAPER_DATASETS_FULL", "TokenStream", "synthetic_lm_batch"]
