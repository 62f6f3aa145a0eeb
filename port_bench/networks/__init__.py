"""
Observation networks, one module each, found by the configuration's
``obs_network``: ``build(config, seed) -> {name: numpy array}``, handed to
the entry and the reference as attributes of the inputs. The 1-D networks
give ``obs_idx [o]`` (the observed column), ``grid_x [g, 1]`` and
``obs_x [o, 1]`` (coordinates, the observations sorted). A network drawn
from the seed keeps its sizes whatever the seed.
"""
