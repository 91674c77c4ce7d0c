"""Analysis helpers the serving tier needs (only the lock factory)."""
