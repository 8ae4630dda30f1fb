"""The drivers: one a kind of work, named by a mix's `driver` key."""
