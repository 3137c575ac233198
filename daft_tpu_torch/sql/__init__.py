from daft_tpu_torch.sql.sql import sql, sql_expr

__all__ = ["sql", "sql_expr"]
