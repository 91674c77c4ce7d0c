"""Input generators, one file each, found by a configuration's ``generator``."""
