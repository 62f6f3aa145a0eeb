"""The share of the traced window in which the card waited for the host:
over the idle gaps that end at a device operation, the part of each
before that operation's launch (:meth:`port_bench.attribution.SpanTable.
late_us`); None without the launches (:mod:`port_bench.attribution`)."""


def read(table):
    if getattr(table, "launch", None) is None or not table.ops \
            or table.window_s <= 0.0:
        return None
    return 100.0 * table.late_us() * 1e-6 / table.window_s
