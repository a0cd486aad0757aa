"""One driver per kind of configuration, found by the ``kind`` its
configuration file names: ``drivers/<kind>.py`` defines ``Cell``."""
