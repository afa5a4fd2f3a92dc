"""Protocol layer: task assignment, attacks, aggregators, compression, the
round and the trainer."""
