"""The plain reference: pairs, levels and EM from the DataFrame alone."""
