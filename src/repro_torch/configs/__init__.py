"""Architecture and run configurations: the reference's table, with torch dtypes."""
