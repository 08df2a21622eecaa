"""The evaluation harness of the port (``volpick_tpu/eval`` in PyTorch):
target CSVs, the task-0 threshold sweep, task-1/2/3 scoring and parsing."""
from volpick_tpu_torch.eval.targets import (
    generate_task0,
    generate_task1,
    generate_task23,
    select_window_containing,
)
from volpick_tpu_torch.eval.task0 import (
    count_TP_FP_FN,
    calculate_precision_recall_F1score,
    compute_residuals,
    eval_task0,
    opt_prob_metrics,
    collect_task0_results,
)
from volpick_tpu_torch.eval.task123 import eval_tasks123, parse_task1, parse_task23, collect_task123_results

__all__ = [
    "generate_task0",
    "generate_task1",
    "generate_task23",
    "select_window_containing",
    "count_TP_FP_FN",
    "calculate_precision_recall_F1score",
    "compute_residuals",
    "eval_task0",
    "opt_prob_metrics",
    "collect_task0_results",
    "eval_tasks123",
    "parse_task1",
    "parse_task23",
    "collect_task123_results",
]
