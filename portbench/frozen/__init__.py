"""Frozen yardsticks: copies that later changes to the program do not move."""
