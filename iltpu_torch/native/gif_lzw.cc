// GIF's LZW compression of one image's palette indices (GIF89a, section 22
// and appendix F): variable-length codes of 9 to 12 bits (8-bit indices),
// least significant bit first, a clear code first and whenever the code
// table is full, the end code last, packed into data sub-blocks of at most
// 255 bytes and a zero-length terminator. The port's GIF writer
// (iltpu_torch/utils/gif.py) calls it through ctypes; it is built with g++
// at first use into iltpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxCode = 4095;
constexpr int kHashSize = 8192;  // open addressing, load <= 0.47

struct BitWriter {
  std::vector<uint8_t> bytes;
  uint32_t acc = 0;
  int nbits = 0;
  void put(int code, int size) {
    acc |= (uint32_t)code << nbits;
    nbits += size;
    while (nbits >= 8) {
      bytes.push_back((uint8_t)(acc & 0xff));
      acc >>= 8;
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) bytes.push_back((uint8_t)(acc & 0xff));
    acc = 0;
    nbits = 0;
  }
};

}  // namespace

extern "C" {

// Compress n indices (each < 2^min_code_size) into out as the image's
// table-based data: the LZW minimum code size byte, the sub-blocks and the
// terminator. Returns the bytes written, or -1 if cap is too small.
int64_t gif_lzw_encode(const uint8_t* idx, int64_t n, int min_code_size, uint8_t* out,
                       int64_t cap) {
  const int clear = 1 << min_code_size, eoi = clear + 1;
  std::vector<uint32_t> keys(kHashSize);  // (prefix << 8 | byte) + 1; 0: empty
  std::vector<int16_t> codes(kHashSize);
  BitWriter w;
  w.bytes.reserve((size_t)n + 64);
  int size = min_code_size + 1, max_code = eoi;
  std::fill(keys.begin(), keys.end(), 0u);
  w.put(clear, size);
  if (n > 0) {
    int prefix = idx[0];
    for (int64_t i = 1; i < n; i++) {
      const int c = idx[i];
      const uint32_t key = ((uint32_t)prefix << 8 | (uint32_t)c) + 1;
      uint32_t h = (key * 2654435761u) >> 19;  // 13 bits
      int found = -1;
      while (keys[h]) {
        if (keys[h] == key) {
          found = codes[h];
          break;
        }
        h = (h + 1) & (kHashSize - 1);
      }
      if (found >= 0) {
        prefix = found;
        continue;
      }
      w.put(prefix, size);
      keys[h] = key;
      codes[h] = (int16_t)++max_code;
      if (max_code >= (1 << size) && size < 12) size++;
      if (max_code == kMaxCode) {  // table full: start a new one
        w.put(clear, size);
        std::fill(keys.begin(), keys.end(), 0u);
        size = min_code_size + 1;
        max_code = eoi;
      }
      prefix = c;
    }
    w.put(prefix, size);
  }
  w.put(eoi, size);
  w.flush();
  const int64_t len = (int64_t)w.bytes.size();
  const int64_t need = 1 + len + (len + 254) / 255 + 1;
  if (need > cap) return -1;
  int64_t k = 0;
  out[k++] = (uint8_t)min_code_size;
  for (int64_t at = 0; at < len; at += 255) {
    const int64_t m = len - at < 255 ? len - at : 255;
    out[k++] = (uint8_t)m;
    std::memcpy(out + k, w.bytes.data() + at, (size_t)m);
    k += m;
  }
  out[k++] = 0;
  return k;
}

}  // extern "C"
