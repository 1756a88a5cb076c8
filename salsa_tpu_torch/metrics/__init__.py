"""DCASE SELD scoring: CSV I/O, the 2020/2021 metrics and directory scoring."""
