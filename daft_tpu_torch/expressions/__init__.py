from daft_tpu_torch.expressions.expression import Expression, col, element, interval, lit

__all__ = ["Expression", "col", "element", "interval", "lit"]
