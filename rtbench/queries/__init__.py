"""Query kinds: the timed call of a configuration's query and its check."""
