"""Block storage pricing (counterpart of ``repro/storage``): the flat-LRU
demand cost for now; the tiered hierarchy arrives with the tiered-storage
slice of the port."""
