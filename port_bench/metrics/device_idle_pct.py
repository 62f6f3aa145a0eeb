"""The share of the traced dispatch-ahead window in which no device
operation ran."""


def read(table):
    if not table.ops or table.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - table.busy_s / table.window_s)
