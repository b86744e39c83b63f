"""The yardstick's arithmetic: peak rates of the card and the least work of
each kernel's call, frozen here so that the benchmark, not the program,
decides what a roofline share counts."""
