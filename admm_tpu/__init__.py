"""admm_tpu — an accelerator operator-splitting (ADMM) statistical framework.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
R/C++ ADMM package (Lasso, Elastic Net, LAD, Basis Pursuit, Dantzig
selector; serial FADMM engines plus consensus parallel ADMM), designed
for an accelerator (the GPU):

* pure-functional solver engines over immutable state pytrees, iterated
  with ``lax.while_loop`` inside ``jit``;
* whole lambda paths (warm starts included) as a single compiled XLA
  program via ``lax.scan``;
* factorization-backed x-updates turned into matvecs (one-time SPD
  inverses instead of per-iteration triangular solves);
* Spectra's Lanczos largest-eigenvalue estimates replaced by on-device
  power iteration;
* consensus ADMM sharded across a device mesh with ``shard_map`` and one
  fused ``psum`` per iteration.

Public API mirrors the reference's five exports (reference: NAMESPACE:9-13)
as chainable builders::

    import admm_tpu
    fit = admm_tpu.admm_lasso(x, y).penalty(nlambda=50).fit()
    fit.beta          # sparse (p+1) x nlambda coefficient matrix
    fit.plot()
"""
from __future__ import annotations

from .api import (ADMMBP, ADMMLAD, ADMMDantzig, ADMMEnet, ADMMLasso,
                  admm_bp, admm_dantzig, admm_enet, admm_lad, admm_lasso)
from .models.bp import bp_fit, bp_fit_batch
from .models.lasso import (adaptive_lasso_path, enet_path,
                           lasso_path)
from .models.lad import lad_fit
from .models.dantzig import dantzig_path
from .models.cv import (cv_dantzig_path, cv_enet_path,
                        cv_fused_lasso_path, cv_gen_lasso_path,
                        cv_glm_path, cv_group_lasso_path,
                        cv_lasso_path, cv_logistic_path,
                        cv_multinomial_path, cv_multitask_lasso_path,
                        cv_slope_path, cv_sqrt_lasso_path,
                        cv_constrained_lasso_path, cv_zerosum_lasso_path)
from .models.glm import (GLMFamily, binomial, binomial_cloglog,
                         binomial_probit, gamma_log, glm_lasso_path,
                         huber, huber_lasso_path, negative_binomial,
                         poisson, poisson_lasso_path)
from .models.genlasso import (difference_matrix, difference_matrix_2d,
                              fused_lasso_path, gen_lasso_path)
from .models.grouplasso import group_lasso_path
from .models.lad import quantile_fit
from .models.quantile import (cv_quantile_lasso_path, pinball_loss,
                              quantile_lasso_path)
from .models.rpca import cv_rpca, rpca_path
from .models.multinomial import multinomial_lasso_path
from .models.cox import cox_lasso_path, cv_cox_path, survfit_cox
from .models.multitask import (multitask_lasso_path,
                               multitask_nuclear_path)
from .models.relaxed import (cv_relaxed_lasso_path,
                             relaxed_lasso_path)
from .models.logistic import logistic_lasso_path
from .models.glasso import (cv_glasso_path, empirical_covariance,
                            glasso_path, partial_correlations)
from .models.svm import cv_svm_path, svm_fit, svm_path
from .models.rpca import matrix_complete, rpca
from .models.slope import bh_sequence, slope_path
from .models.conlasso import constrained_lasso_path, zerosum_lasso_path
from .models.sqrtlasso import sqrt_lasso_path
from .data.makex import make_x
from .predict import coef, predict
from .assess import assess, c_index, confusion, roc
from .glmnet import big_glm, cv_glmnet, glmnet
from .summary import deviance, format_path_table, path_table
from .parallel.consensus import (parallel_bp_fit,
                                 parallel_constrained_lasso_path,
                                 parallel_enet_path,
                                 parallel_glm_lasso_path,
                                 parallel_group_lasso_path,
                                 parallel_huber_lasso_path,
                                 parallel_lasso_path,
                                 parallel_logistic_lasso_path,
                                 parallel_multinomial_lasso_path,
                                 parallel_multitask_lasso_path,
                                 parallel_poisson_lasso_path,
                                 parallel_slope_path,
                                 parallel_zerosum_lasso_path)

__version__ = "0.1.0"

__all__ = [
    "admm_lasso", "admm_enet", "admm_lad", "admm_bp", "admm_dantzig",
    "ADMMLasso", "ADMMEnet", "ADMMLAD", "ADMMBP", "ADMMDantzig",
    "cv_lasso_path", "cv_enet_path", "bp_fit", "bp_fit_batch",
    "lasso_path", "enet_path", "adaptive_lasso_path",
    "lad_fit", "dantzig_path",
    "group_lasso_path", "cv_group_lasso_path",
    "gen_lasso_path", "fused_lasso_path", "difference_matrix",
    "difference_matrix_2d",
    "logistic_lasso_path", "cv_logistic_path",
    "parallel_logistic_lasso_path", "parallel_glm_lasso_path",
    "parallel_huber_lasso_path", "parallel_poisson_lasso_path",
    "glm_lasso_path", "huber_lasso_path", "poisson_lasso_path",
    "GLMFamily", "binomial", "huber", "poisson", "binomial_probit",
    "binomial_cloglog", "gamma_log", "negative_binomial",
    "cv_glm_path", "quantile_fit", "cv_dantzig_path",
    "cv_gen_lasso_path", "cv_fused_lasso_path",
    "multitask_lasso_path", "multinomial_lasso_path", "predict",
    "path_table", "format_path_table", "deviance",
    "assess", "roc", "confusion", "c_index",
    "glmnet", "cv_glmnet", "coef", "big_glm", "make_x",
    "relaxed_lasso_path", "cv_relaxed_lasso_path", "cox_lasso_path", "cv_cox_path",
    "survfit_cox",
    "glasso_path", "cv_glasso_path", "empirical_covariance",
    "partial_correlations",
    "svm_fit", "svm_path", "cv_svm_path", "rpca", "matrix_complete",
    "rpca_path", "cv_rpca",
    "quantile_lasso_path", "cv_quantile_lasso_path", "pinball_loss",
    "slope_path", "bh_sequence", "cv_slope_path",
    "constrained_lasso_path", "zerosum_lasso_path", "sqrt_lasso_path",
    "cv_sqrt_lasso_path", "cv_constrained_lasso_path",
    "cv_zerosum_lasso_path",
    "cv_multitask_lasso_path", "cv_multinomial_path",
    "multitask_nuclear_path",
    "parallel_multinomial_lasso_path", "parallel_multitask_lasso_path",
    "parallel_lasso_path", "parallel_enet_path",
    "parallel_group_lasso_path", "parallel_bp_fit",
    "parallel_slope_path", "parallel_constrained_lasso_path",
    "parallel_zerosum_lasso_path",
    "__version__",
]
