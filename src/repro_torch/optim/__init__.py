"""AdamW for the port's trainer."""
