// Native data-pipeline kernels: CRC32C and TFRecord framing.
//
// The reference's data path leaned on TensorFlow's C++ TFRecord machinery;
// this framework's python codec (data/tfrecord.py) is dependency-free but
// the table-driven python CRC32C runs at a few MB/s — too slow
// for building 240k-image datasets (dataset_tool.py create_mnistrgb scale).
// This library provides a slice-by-8 CRC32C and whole-file record
// framing/scanning; python keeps the protobuf logic.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

uint32_t kTable[8][256];
bool kInit = false;

void init_tables() {
  if (kInit) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    kTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = kTable[0][i];
    for (int t = 1; t < 8; ++t) {
      c = kTable[0][c & 0xFF] ^ (c >> 8);
      kTable[t][i] = c;
    }
  }
  kInit = true;
}

uint32_t crc32c_impl(const uint8_t* data, size_t n, uint32_t crc) {
  init_tables();
  crc ^= 0xFFFFFFFFu;
  while (n >= 8) {
    const uint32_t lo = crc ^ (static_cast<uint32_t>(data[0]) |
                               (static_cast<uint32_t>(data[1]) << 8) |
                               (static_cast<uint32_t>(data[2]) << 16) |
                               (static_cast<uint32_t>(data[3]) << 24));
    crc = kTable[7][lo & 0xFF] ^ kTable[6][(lo >> 8) & 0xFF] ^
          kTable[5][(lo >> 16) & 0xFF] ^ kTable[4][(lo >> 24) & 0xFF] ^
          kTable[3][data[4]] ^ kTable[2][data[5]] ^
          kTable[1][data[6]] ^ kTable[0][data[7]];
    data += 8;
    n -= 8;
  }
  while (n--) crc = kTable[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  const uint32_t c = crc32c_impl(data, n, 0);
  return ((c >> 15) | (c << 17)) + 0xA282EAD8u;
}

}  // namespace

extern "C" {

unsigned int dk_crc32c(const unsigned char* data, long n, unsigned int crc) {
  return crc32c_impl(data, static_cast<size_t>(n), crc);
}

// Append one framed record to an open file (path opened in append mode).
// Returns 0 on success.
int dk_write_record(const char* path, const unsigned char* payload, long n) {
  FILE* f = std::fopen(path, "ab");
  if (!f) return 1;
  uint64_t len = static_cast<uint64_t>(n);
  uint8_t header[8];
  std::memcpy(header, &len, 8);  // little-endian hosts only (x86/ARM)
  const uint32_t hcrc = masked_crc(header, 8);
  const uint32_t pcrc = masked_crc(payload, static_cast<size_t>(n));
  int ok = std::fwrite(header, 1, 8, f) == 8 &&
           std::fwrite(&hcrc, 4, 1, f) == 1 &&
           std::fwrite(payload, 1, static_cast<size_t>(n), f) ==
               static_cast<size_t>(n) &&
           std::fwrite(&pcrc, 4, 1, f) == 1;
  std::fclose(f);
  return ok ? 0 : 2;
}

// Batched framing into a caller buffer: given `count` payloads laid out
// back-to-back in `payloads` with sizes[], emit the framed stream into out
// (caller sizes it as sum(sizes) + 16*count). Returns bytes written.
long dk_frame_records(const unsigned char* payloads, const long* sizes,
                      long count, unsigned char* out) {
  long off_in = 0, off_out = 0;
  for (long i = 0; i < count; ++i) {
    const long n = sizes[i];
    uint64_t len = static_cast<uint64_t>(n);
    std::memcpy(out + off_out, &len, 8);
    const uint32_t hcrc = masked_crc(out + off_out, 8);
    std::memcpy(out + off_out + 8, &hcrc, 4);
    std::memcpy(out + off_out + 12, payloads + off_in, n);
    const uint32_t pcrc = masked_crc(payloads + off_in, n);
    std::memcpy(out + off_out + 12 + n, &pcrc, 4);
    off_in += n;
    off_out += 16 + n;
  }
  return off_out;
}

// Scan a record file: fills offsets[] and lengths[] (payload spans) up to
// max_records; returns the number of records found, or -1 on framing error.
long dk_scan_records(const char* path, long* offsets, long* lengths,
                     long max_records, int verify) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  long count = 0;
  long pos = 0;
  std::vector<uint8_t> buf;
  while (count < max_records) {
    uint8_t header[8];
    if (std::fread(header, 1, 8, f) != 8) break;
    uint32_t hcrc;
    if (std::fread(&hcrc, 4, 1, f) != 1) { count = -1; break; }
    if (verify && masked_crc(header, 8) != hcrc) { count = -1; break; }
    uint64_t len;
    std::memcpy(&len, header, 8);
    offsets[count] = pos + 12;
    lengths[count] = static_cast<long>(len);
    if (verify) {
      buf.resize(len);
      if (std::fread(buf.data(), 1, len, f) != len) { count = -1; break; }
      uint32_t pcrc;
      if (std::fread(&pcrc, 4, 1, f) != 1) { count = -1; break; }
      if (masked_crc(buf.data(), len) != pcrc) { count = -1; break; }
    } else {
      if (std::fseek(f, static_cast<long>(len) + 4, SEEK_CUR) != 0) {
        count = -1;
        break;
      }
    }
    pos += 16 + static_cast<long>(len);
    ++count;
  }
  std::fclose(f);
  return count;
}

}  // extern "C"
