"""Hash probe: an int32 key to its slot in a bucketed table, -1 if absent."""
