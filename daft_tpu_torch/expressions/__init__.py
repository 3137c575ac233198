from daft_tpu_torch.expressions.expression import Expression, col, interval, lit

__all__ = ["Expression", "col", "interval", "lit"]
