from daft_tpu_torch.expressions.expression import Expression, col, lit

__all__ = ["Expression", "col", "lit"]
