"""Worker execution core: Operator protocol, Driver loop, task/operator
contexts (the presto-main execution/operator layer, SURVEY §2.6)."""
