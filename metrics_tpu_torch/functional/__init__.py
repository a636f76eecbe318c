from metrics_tpu_torch.functional.classification.accuracy import accuracy  # noqa: F401
from metrics_tpu_torch.functional.classification.auc import auc  # noqa: F401
from metrics_tpu_torch.functional.classification.auroc import auroc  # noqa: F401
from metrics_tpu_torch.functional.classification.average_precision import average_precision  # noqa: F401
from metrics_tpu_torch.functional.classification.cohen_kappa import cohen_kappa  # noqa: F401
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix  # noqa: F401
from metrics_tpu_torch.functional.classification.dice import dice_score  # noqa: F401
from metrics_tpu_torch.functional.classification.f_beta import f1, fbeta  # noqa: F401
from metrics_tpu_torch.functional.classification.hamming_distance import hamming_distance  # noqa: F401
from metrics_tpu_torch.functional.classification.hinge import hinge  # noqa: F401
from metrics_tpu_torch.functional.classification.iou import iou  # noqa: F401
from metrics_tpu_torch.functional.classification.matthews_corrcoef import matthews_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.classification.precision_recall import precision, precision_recall, recall  # noqa: F401
from metrics_tpu_torch.functional.classification.precision_recall_curve import precision_recall_curve  # noqa: F401
from metrics_tpu_torch.functional.classification.roc import roc  # noqa: F401
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores  # noqa: F401
from metrics_tpu_torch.functional.regression.explained_variance import explained_variance  # noqa: F401
from metrics_tpu_torch.functional.regression.mean_absolute_error import mean_absolute_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mean_relative_error import mean_relative_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mean_squared_error import mean_squared_error  # noqa: F401
from metrics_tpu_torch.functional.regression.mean_squared_log_error import mean_squared_log_error  # noqa: F401
from metrics_tpu_torch.functional.regression.psnr import psnr  # noqa: F401
from metrics_tpu_torch.functional.regression.r2score import r2score  # noqa: F401
from metrics_tpu_torch.functional.regression.ssim import ssim  # noqa: F401
from metrics_tpu_torch.functional.retrieval.average_precision import retrieval_average_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.precision import retrieval_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.recall import retrieval_recall  # noqa: F401
from metrics_tpu_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank  # noqa: F401
