"""No forecast: each step is the analysis of its prior alone."""


def program(model):
    return None


def reference(model):
    return lambda x: x


def work(model, k, g):
    return {}
